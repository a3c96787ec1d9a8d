"""Models of the port: the dense ``attn_mlp`` transformer and its parts."""
