"""End-to-end pipeline models and their checkpoints."""

from .pipeline import SARChangePipeline, change_features, multilook
from .checkpoint import Checkpointer, load_params, save_params

__all__ = ['SARChangePipeline', 'multilook', 'change_features',
           'save_params', 'load_params', 'Checkpointer']
