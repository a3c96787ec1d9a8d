from repro_torch.data.pipeline import Prefetcher, ar1_stream  # noqa: F401
from repro_torch.data.synthetic import make_batch, make_specs, token_stream  # noqa: F401
