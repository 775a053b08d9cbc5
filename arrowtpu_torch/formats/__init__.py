"""File and interchange formats: the Arrow physical layout."""

from . import layout
