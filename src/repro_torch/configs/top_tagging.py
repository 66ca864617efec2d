"""Paper benchmark 1: Top quark tagging (Table 1).

Sequence 20 x 6 features -> RNN(hidden 20) -> Dense(64, ReLU) -> sigmoid.
Trainable params: 3,569 (LSTM) / 3,089 (GRU); RNN-layer params 2,160 / 1,680.
"""

from repro_torch.config import ModelConfig, RNNConfig


def _cfg(cell: str) -> ModelConfig:
    return ModelConfig(
        name=f"top-tagging-{cell}",
        family="rnn",
        rnn=RNNConfig(
            cell=cell,
            hidden=20,
            seq_len=20,
            input_size=6,
            dense_sizes=(64,),
            n_outputs=1,
            output_activation="sigmoid",
        ),
        param_dtype="float32",
        compute_dtype="float32",
    )


def lstm_config() -> ModelConfig:
    return _cfg("lstm")


def gru_config() -> ModelConfig:
    return _cfg("gru")


CONFIG = lstm_config()
