"""Paper benchmark 3: QuickDraw 5-class stroke classification (Table 1).

Sequence 100 x 3 (x, y, t) -> RNN(hidden 128) -> Dense(256) -> Dense(128)
-> softmax(5).  Params: 134,149 (LSTM) / 117,637 (GRU); RNN 67,584 / 51,072.
"""

from repro_torch.config import ModelConfig, RNNConfig


def _cfg(cell: str) -> ModelConfig:
    return ModelConfig(
        name=f"quickdraw-{cell}",
        family="rnn",
        rnn=RNNConfig(
            cell=cell,
            hidden=128,
            seq_len=100,
            input_size=3,
            dense_sizes=(256, 128),
            n_outputs=5,
            output_activation="softmax",
        ),
        param_dtype="float32",
        compute_dtype="float32",
    )


def lstm_config() -> ModelConfig:
    return _cfg("lstm")


def gru_config() -> ModelConfig:
    return _cfg("gru")


CONFIG = lstm_config()
