"""Serving: the chat prompt format, the streaming decoder, and the
continuous-batching engines (dense slots and the paged pool, on one device
or over a mesh of ranks), and the OpenAI-style HTTP server over an engine."""
from .api_server import GLMAPIServer
from .chat import chat_template, process_response
from .decoder import GLMDecoder
from .dist_engine import DistributedPagedServingEngine, DistributedServingEngine
from .engine import ServingEngine
from .paged_engine import PagedServingEngine
