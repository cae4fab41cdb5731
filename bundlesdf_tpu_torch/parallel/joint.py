"""The online joint loop under data parallelism: rank 0 is the tracker of
record (the port's counterpart of the JAX ``BundleSdf`` with ``dp_devices >
1``, whose single controller runs one tracker and shards only the NOF step
over its device mesh, ``bundlesdf_tpu/nof/runner.py:436-448``).

Here a process is a rank.  One tracker a rank could admit different
keyframes where two trackers differ by an ulp, so only rank 0 tracks.  Its
``NofRunner`` is a :class:`LeadRunner`: every call that runs a collective
or changes the state the steps read (construction, ``add_new_frames``,
``set_poses``, the training calls, ``calibrate_step_ms``, ``train_ba``,
checkpoints) is first sent, with its arguments, to the other ranks, which
:func:`follow` the commands on their own ``NofRunner`` until rank 0 sends
``stop``.  The queries that the scheduler asks (``pending_chunks``,
``train_queue_ready``, ``loop_chunk``, ``n_frames``) and the outputs
(``get_optimized_poses_in_real_world``, ``extract_mesh``) stay on rank 0:
they run no collective, the pose array is replicated and, with the table
sharded, every step all-gathers the whole table onto every rank.

The commands travel on a gloo group of the mesh's ranks
(``broadcast_object_list``), so they take the host path whatever backend
the steps' collectives use.  A rank that raises ends its process; the
other ranks' next collective or command then fails on the closed
connection, so no rank waits on a peer that is gone.
"""
from __future__ import annotations

import functools

import torch.distributed as dist

from ..nof.runner import NofRunner
from .mesh import Mesh

# NofRunner methods that rank 0 sends to the other ranks before it runs them
FORWARDED = ("add_new_frames", "set_poses", "train", "train_advance", "train_drain",
             "calibrate_step_ms", "train_ba", "save_weights", "load_weights")


class Channel:
    """Rank 0's commands to the other ranks of ``mesh``: ``(name, args,
    kwargs)`` broadcast on a gloo group of its ranks.  Every rank of the
    default group must build it at the same point (``new_group`` is
    collective)."""

    def __init__(self, mesh: Mesh):
        self.src = mesh.ranks[0]
        self.group = dist.new_group(list(mesh.ranks), backend="gloo")
        self.stopped = False

    def send(self, name: str, *args, **kwargs) -> None:
        if self.stopped:
            raise RuntimeError(f"the dp ranks were stopped: cannot send {name!r}")
        dist.broadcast_object_list([(name, args, kwargs)], src=self.src, group=self.group)
        self.stopped = name == "stop"

    def recv(self) -> tuple:
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]


class LeadRunner(NofRunner):
    """Rank 0's ``NofRunner``: it sends its construction and each call of
    :data:`FORWARDED` to the other ranks before running it.  A forwarded
    call made inside another (``calibrate_step_ms`` trains through
    ``train_advance``) is not sent again: the followers make it
    themselves."""

    def __init__(self, channel: Channel, cfg, *inputs, **kwargs):
        self._channel = channel
        self._nested = 0
        channel.send("init", cfg, *inputs)
        super().__init__(cfg, *inputs, **kwargs)


def _forwarded(name: str):
    method = getattr(NofRunner, name)

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        if not self._nested:
            self._channel.send(name, *args, **kwargs)
        self._nested += 1
        try:
            return method(self, *args, **kwargs)
        finally:
            self._nested -= 1

    return call


for _name in FORWARDED:
    setattr(LeadRunner, _name, _forwarded(_name))


def follow(channel: Channel, device=None, train_draws=None) -> NofRunner | None:
    """The loop of a rank other than 0: build the ``NofRunner`` that rank 0
    builds (on ``device``, drawing from ``train_draws``, which must give the
    same draws as rank 0's) and make each call it sends, until ``stop``.
    Returns the runner (None when no round started)."""
    runner = None
    while True:
        name, args, kwargs = channel.recv()
        if name == "stop":
            return runner
        if name == "init":
            runner = NofRunner(*args, device=device, train_draws=train_draws)
        elif name in FORWARDED and runner is not None:
            getattr(runner, name)(*args, **kwargs)
        else:
            raise RuntimeError(f"dp follower: unexpected command {name!r}")
