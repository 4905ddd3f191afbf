"""Process-wide state of the port's Horovod API: rank, size, and the
process group with the backend it runs on.

Counterpart of ``sparkdl_tpu/hvd/_state.py``. There the launcher exports
``SPARKDL_TPU_*`` variables and ``init()`` joins ``jax.distributed``.
Here ``init()`` reads the names ``torch.distributed`` itself reads
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``). In a gang (``MASTER_ADDR`` and
``MASTER_PORT`` set) it binds the rank's card, then joins the default
process group through a client of the driver's ``TCPStore``, at every
world size, one included. Without them it is rank 0 of 1 with no group.
In local mode (``HorovodRunner(np=-1)``) the runner enters
:func:`local_mode`, which pins rank 0 of 1 without any rendezvous.

The launcher decides the device of a rank that has a card of its own
(a one-card-a-slot gang, a Spark task, a remote rank) and hands it to
:func:`init` as ``device``: ``"cuda"`` binds ``cuda:LOCAL_RANK`` and
raises when this host has no such card; ``"cpu"`` runs the rank on the
CPU over gloo (the launcher's ``WORKER_DEVICE = "cpu"``). A rank never
decides it from its own environment. Without a decision (a local gang,
``np <= -2``) the backend rule below applies.

Backend rule (a declared rule, not a fallback):

- every local rank has a CUDA card of its own: ``"cpu:gloo,cuda:nccl"``.
  CPU tensors and pickled objects go over gloo, CUDA tensors over NCCL,
  on the card;
- ranks share a card (a local gang larger than the card count): gloo
  alone, because NCCL refuses two ranks on one device. The collectives
  stage CUDA tensors through host memory;
- no card at all (a CPU gang, ``np <= -2`` on a host without CUDA): gloo.
"""

import contextlib
import datetime
import logging
import os
import threading

import torch
import torch.distributed as dist

logger = logging.getLogger("HorovodRunner")

# how long a rank waits for the store, the group's rendezvous and any one
# collective before it raises (torch.distributed's own default for gloo)
TIMEOUT = datetime.timedelta(minutes=30)

PER_CARD_BACKEND = "cpu:gloo,cuda:nccl"
SHARED_BACKEND = "gloo"


class _HvdState:
    def __init__(self):
        self.lock = threading.RLock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.group = None  # the default process group, in a gang
        self.backend = None  # PER_CARD_BACKEND or SHARED_BACKEND
        self.device = None  # the card this rank binds, or the CPU
        self.master = None  # (address, port) of the store the group joined
        self.local = False  # inside local_mode(): no environment, no group

    @property
    def nccl(self):
        """True when CUDA tensors go over NCCL, on the card."""
        return self.backend == PER_CARD_BACKEND

    def snapshot(self):
        return (self.initialized, self.rank, self.size, self.local_rank,
                self.local_size, self.group, self.backend,
                self.device, self.master, self.local)

    def restore(self, snap):
        (self.initialized, self.rank, self.size, self.local_rank,
         self.local_size, self.group, self.backend,
         self.device, self.master, self.local) = snap


_state = _HvdState()


def state():
    return _state


def backend_for(local_rank, local_size, device=None):
    """(backend, device) of a gang rank: the launcher's decision
    ``device`` (``"cuda"``, ``"cpu"``), or the rule in the module
    docstring when it is None."""
    if device == "cpu":
        return SHARED_BACKEND, torch.device("cpu")
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < local_size:
            raise RuntimeError(
                f"local rank {local_rank} of {local_size} of a gang with a "
                f"card a rank finds {cards} CUDA device(s) on this host; "
                "no such rank moves to the CPU or to a shared card")
        return PER_CARD_BACKEND, torch.device("cuda", local_rank)
    if device is not None:
        raise ValueError(f"a rank's device is 'cuda' or 'cpu', not "
                         f"{device!r}")
    if not torch.cuda.is_available():
        return SHARED_BACKEND, torch.device("cpu")
    cards = torch.cuda.device_count()
    if local_size <= cards:
        return PER_CARD_BACKEND, torch.device("cuda", local_rank)
    return SHARED_BACKEND, torch.device("cuda", local_rank % cards)


def init(device=None):
    """Resolve rank and size; in a gang, bind the card and join the
    process group (the counterpart of the JAX package's
    ``jax.distributed.initialize`` against the launcher's coordinator).
    ``device``: the launcher's decision for this rank (module
    docstring). A second call is a no-op until :func:`shutdown`."""
    with _state.lock:
        if _state.initialized:
            return
        if _state.local:
            _state.initialized = True
            return
        env = os.environ
        size = int(env.get("WORLD_SIZE", "1"))
        rank = int(env.get("RANK", "0"))
        local_rank = int(env.get("LOCAL_RANK", str(rank)))
        local_size = int(env.get("LOCAL_WORLD_SIZE", str(size)))
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if addr and port:
            backend, device = backend_for(local_rank, local_size, device)
            if device.type == "cuda":
                # before the group exists, so NCCL binds this card
                torch.cuda.set_device(device)
            store = dist.TCPStore(addr, int(port), is_master=False,
                                  timeout=TIMEOUT)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, timeout=TIMEOUT)
            _state.group = dist.group.WORLD
            _state.backend, _state.device = backend, device
            _state.master = (addr, int(port))
            logger.info("hvd rank %d of %d (local %d of %d): backend %s on "
                        "%s", rank, size, local_rank, local_size, backend,
                        device)
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.initialized = True


def shutdown():
    """Leave the process group (if :func:`init` joined one) and reset to
    rank 0 of 1."""
    with _state.lock:
        if _state.group is not None:
            dist.destroy_process_group()
        local = _state.local
        _state.restore(_HvdState().snapshot())
        _state.local = local


def require_initialized():
    if not _state.initialized:
        raise ValueError(
            "Horovod has not been initialized; call hvd.init() first.")


@contextlib.contextmanager
def local_mode():
    """Single-process mode of ``HorovodRunner(np=-1)``: ``hvd.init()``
    inside the user's main resolves to rank 0 of 1 with no process
    group, and every collective returns its input's value."""
    with _state.lock:
        prev = _state.snapshot()
        _state.restore(_HvdState().snapshot())
        _state.local = True
    try:
        yield
    finally:
        with _state.lock:
            _state.restore(prev)
