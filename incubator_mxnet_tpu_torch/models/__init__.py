"""Model families served by the port."""
from .bert import (BERTModel, BERTEncoder, MultiHeadAttention,  # noqa: F401
                   TransformerEncoderLayer)
from .gpt import GPTModel, TransformerDecoderLayer  # noqa: F401
