from repro_torch.core.rnn.cells import (  # noqa: F401
    gru_cell,
    initial_state,
    lstm_cell,
    rnn_param_specs,
    tiled_matmul,
)
from repro_torch.core.rnn.layer import rnn_layer  # noqa: F401
