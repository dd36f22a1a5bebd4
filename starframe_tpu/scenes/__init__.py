"""Programmatic scene builders: the 5 driver-normative bench configs
(BASELINE.json:7-11) plus helpers. The array-program stand-in for starframe's
``examples/sandbox`` demo scenes (SURVEY.md §2 row 19) — the de-facto
integration suite of the reference.
"""

from .base import Scene
from .box_stack import box_stack
from .pile import pile, pile_compound, pile_joints
from .rope_bridge import rope_bridge
from .mechanism import mechanism
from .batched import batched_worlds, batchify

__all__ = ["Scene", "box_stack", "pile", "pile_compound", "pile_joints", "rope_bridge", "mechanism", "batched_worlds", "batchify"]
