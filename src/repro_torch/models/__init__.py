"""Models of the port: the dense ``attn_mlp`` transformer and its parts,
and the predict-fn builders that serve them from a chain bank."""

from repro_torch.models.predictive import (  # noqa: F401
    bma_logits,
    mlp_predict,
    regression_predict,
    transformer_next_token_predict,
)
from repro_torch.models.transformer import Model, init_params, loss_fn  # noqa: F401
