"""Examples: plain dicts of numpy arrays.

The part of music_spectrogram_diffusion_tpu/data/core.py that the port's
MIDI front end needs (the `Example` type); the lazy Dataset pipeline waits
for the data pipeline's port.
"""

from __future__ import annotations

from typing import Any, Dict

Example = Dict[str, Any]
