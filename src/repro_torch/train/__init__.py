"""Training loop of the port: the gradient oracle and the chunked
:class:`~repro_torch.train.engine.Engine`."""
