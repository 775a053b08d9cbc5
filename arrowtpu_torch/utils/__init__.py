"""Aux utilities: pretty printing, memory accounting and metrics, data
generation."""

from . import datagen, metrics, pretty
from .metrics import Metrics, TrackingMemoryPool, buffer_memory_size
from .pretty import pretty_format_batches, print_batches
