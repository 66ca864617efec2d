from repro_torch.core.rnn.cells import (  # noqa: F401
    gru_cell,
    gru_cell_quantized,
    initial_state,
    lstm_cell,
    lstm_cell_quantized,
    quantized_cell_scan,
    rnn_param_specs,
    tiled_matmul,
)
from repro_torch.core.rnn.layer import rnn_layer  # noqa: F401
