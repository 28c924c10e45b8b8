"""Stage-2 training steps of the skeleton model on a ZJU-MoCap subject
(``scene_zju.py``), driven and checked as ``stage2_train.py``'s: the same
program entry (``make_stage2_auto``), window and reference."""
from __future__ import annotations

from portbench import scene_zju, training
from portbench.drivers import stage2_train


class Driver(stage2_train.Driver):
    def setup(self, cache_dir=None):
        """The base's set-up on the subject's body and frames: ``training``
        draws its inputs through its module's ``scene``, which ``scene_zju``
        stands in for while it runs (the same functions by name)."""
        saved, training.scene = training.scene, scene_zju
        try:
            super().setup(cache_dir)
        finally:
            training.scene = saved
