from .core import (
    CHAR_FILTERS,
    TOKEN_FILTERS,
    TOKENIZERS,
    AnalysisService,
    Analyzer,
    Token,
)

__all__ = ["CHAR_FILTERS", "TOKEN_FILTERS", "TOKENIZERS", "AnalysisService",
           "Analyzer", "Token"]
