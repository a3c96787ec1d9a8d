from repro_torch.data.synthetic import make_batch, token_stream  # noqa: F401
