"""Mean device time an epoch of the fused epoch's graph replay in the
traced window: the program's ``train.device.replay_ms`` booking, from CUDA
events just around ``graph.replay()`` in ``train/trainer.py::FusedEpoch``
(the permutation's upload before it left out)."""

from portbench.program_readings import booked_mean


def read(ctx: dict):
    return booked_mean(ctx, "train.device.replay_ms")
