"""Faults that only a CUDA-graph replay of the fused epoch can have
(``train/trainer.py::FusedEpoch``), planted in the program. On a card each
leaves the eager epoch 0 and the first replay as they should be and makes
every later replay train wrongly; on the CPU, where nothing is captured,
they change nothing. The card test and the calibration run a cell under
each and read its numbers.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def _patched(name: str, make):
    from hhrs_tpu_torch.train import trainer

    cls = trainer.FusedEpoch
    old = getattr(cls, name)
    setattr(cls, name, make(old))
    try:
        yield
    finally:
        setattr(cls, name, old)


def stale_perm():
    """The epoch's permutation is uploaded only before the capture: every
    replay trains on epoch 0's batches."""
    def make(run):
        def stale(self, perm):
            if self.graph is None:
                return run(self, perm)
            self.nan.zero_()
            self.model.train()
            self.graph.replay()
            return self.losses.mean()
        return stale
    return _patched("run", make)


def generator_rewound():
    """The dropout generator's state is put back before each replay to what
    it was at the capture, as a graph that keeps the offsets it was
    captured with would leave it: every replay draws the first replay's
    masks."""
    def make(run):
        def rewound(self, perm):
            if self.graph is not None:
                if not hasattr(self, "_generator_at_capture"):
                    self._generator_at_capture = self.generator.get_state()
                self.generator.set_state(self._generator_at_capture)
            return run(self, perm)
        return rewound
    return _patched("run", make)


def frozen_step_count():
    """AdamW's step counts are put back before each replay to what they
    were at the capture: every replay takes the first replay's bias
    corrections."""
    def make(run):
        def frozen(self, perm):
            if self.graph is not None:
                if not hasattr(self, "_steps_at_capture"):
                    self._steps_at_capture = [(st["step"], st["step"].clone()) for st in self.opt.state.values()
                                              if torch.is_tensor(st.get("step"))]
                for t, v in self._steps_at_capture:
                    t.copy_(v)
            return run(self, perm)
        return frozen
    return _patched("run", make)


REPLAY = {"stale_perm": stale_perm, "generator_rewound": generator_rewound,
          "frozen_step_count": frozen_step_count}
