"""Paper benchmark 2: Jet flavor tagging (Table 1).

Sequence 15 x 6 track features -> RNN(hidden 120) -> Dense(50) -> Dense(10)
-> softmax(3).  Params: 67,553 (LSTM) / 52,673 (GRU); RNN layer 60,960 / 46,080.
"""

from repro_torch.config import ModelConfig, RNNConfig


def _cfg(cell: str) -> ModelConfig:
    return ModelConfig(
        name=f"flavor-tagging-{cell}",
        family="rnn",
        rnn=RNNConfig(
            cell=cell,
            hidden=120,
            seq_len=15,
            input_size=6,
            dense_sizes=(50, 10),
            n_outputs=3,
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
