"""Guest serving of the port: the continuous-batching GenerationServer."""
from .serving import GenerationServer, serve_batch

__all__ = ["GenerationServer", "serve_batch"]
