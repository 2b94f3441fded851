from .core import AnalysisService, Analyzer

__all__ = ["AnalysisService", "Analyzer"]
