from .pipeline import DataConfig, PrefetchIterator, SyntheticEmbeds, SyntheticLM, TokenFileSource, make_source  # noqa: F401
