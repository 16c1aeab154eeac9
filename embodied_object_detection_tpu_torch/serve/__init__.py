"""Serving: the HTTP server (`server.py`) and the frame step's export
(`export.py`)."""

from .export import (  # noqa: F401
    export_frame_step, load_frame_step, save_frame_step)
