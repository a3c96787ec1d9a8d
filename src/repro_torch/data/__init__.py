from repro_torch.data.pipeline import ar1_stream  # noqa: F401
from repro_torch.data.synthetic import make_batch, token_stream  # noqa: F401
