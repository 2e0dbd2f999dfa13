"""Serving: the chat prompt format and the streaming decoder."""
from .chat import chat_template, process_response
from .decoder import GLMDecoder
