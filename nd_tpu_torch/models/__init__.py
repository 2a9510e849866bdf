"""End-to-end pipelines."""

from .pipeline import SARChangePipeline, multilook

__all__ = ['SARChangePipeline', 'multilook']
