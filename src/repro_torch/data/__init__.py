from .pipeline import SyntheticTokens, FileTokens, make_pipeline  # noqa: F401
