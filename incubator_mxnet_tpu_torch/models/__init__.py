"""Model families of the port."""
from .bert import (BERTModel, BERTEncoder, ChunkedMLMLoss,  # noqa: F401
                   MultiHeadAttention, TransformerEncoderLayer)
from .gpt import (ChunkedLMLoss, FeaturesView, GPTModel,  # noqa: F401
                  TransformerDecoderLayer)
from .lenet import LeNet  # noqa: F401
from .lstm_lm import LSTMLanguageModel  # noqa: F401
from .ssd import SSD  # noqa: F401
from ..gluon.model_zoo.vision import get_model  # noqa: F401
