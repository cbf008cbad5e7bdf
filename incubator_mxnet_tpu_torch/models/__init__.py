"""Model families of the port."""
from .bert import (BERTModel, BERTEncoder, ChunkedMLMLoss,  # noqa: F401
                   MultiHeadAttention, TransformerEncoderLayer)
from .gpt import (ChunkedLMLoss, FeaturesView, GPTModel,  # noqa: F401
                  TransformerDecoderLayer)
