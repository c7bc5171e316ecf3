from .synthetic import ctr_like, text_like  # noqa: F401
