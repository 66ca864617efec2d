from repro_torch.data.jets import top_tagging_dataset  # noqa: F401
from repro_torch.data.tracks import flavor_tagging_dataset  # noqa: F401
from repro_torch.data.quickdraw import quickdraw_dataset  # noqa: F401
from repro_torch.data.lm_synthetic import lm_token_stream  # noqa: F401
