from .synthetic import (  # noqa: F401
    ctr_like,
    ctr_like_stream,
    natural_to_bipartite,
    social_like,
    social_like_stream,
    text_like,
    text_like_stream,
)
