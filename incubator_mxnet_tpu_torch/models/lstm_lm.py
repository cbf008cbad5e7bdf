"""The LSTM language model (counterpart of
``incubator_mxnet_tpu/models/lstm_lm.py``, MXNet's word-LM example;
BASELINE config 5): embedding → dropout → ``gluon.rnn.LSTM`` (inter-layer
dropout) → dropout → a Dense decoder over the vocabulary. Its defaults
(vocab 10000, embed and hidden 650, 2 layers, dropout 0.5) are the
"medium" PTB LSTM of Zaremba, Sutskever & Vinyals (2014).
"""
from __future__ import annotations

from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["LSTMLanguageModel"]


class LSTMLanguageModel(HybridBlock):
    def __init__(self, vocab_size=10000, embed_size=650, hidden_size=650,
                 num_layers=2, dropout=0.5, tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.embedding = nn.Embedding(vocab_size, embed_size)
            self.lstm = rnn.LSTM(hidden_size, num_layers=num_layers,
                                 dropout=dropout, input_size=embed_size)
            self.decoder = nn.Dense(vocab_size, flatten=False,
                                    in_units=hidden_size)

    def begin_state(self, batch_size, **kwargs):
        """The LSTM's states (h, c), each (layers, batch, hidden): zeros on
        the current context, or ``func(shape, **kwargs)``."""
        return self.lstm.begin_state(batch_size, **kwargs)

    def forward(self, inputs, *states):
        """``inputs`` (T, N) token ids → logits (T, N, vocab); with states
        (a list [h, c], or h and c as two arguments, as a ``TrainStep``
        with ``n_net_inputs=3`` passes them) → (logits, [h, c])."""
        emb = self.drop(self.embedding(inputs))
        if not states or states == (None,):
            return self.decoder(self.drop(self.lstm(emb)))
        if len(states) == 1:
            states = states[0]
        out, states = self.lstm(emb, list(states))
        return self.decoder(self.drop(out)), states
