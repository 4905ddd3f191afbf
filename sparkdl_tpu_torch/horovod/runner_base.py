"""HorovodRunner: runs a distributed training function on a gang of
worker processes.

Counterpart of ``sparkdl_tpu/horovod/runner_base.py``, with the same
signature byte for byte (reference ``runner_base.py:39-103``): the
constructor is keyword-only ``(*, np, driver_log_verbosity=
"log_callback_only")`` and ``run(main, **kwargs)`` returns rank 0's
``main`` return value.

- ``np == -1``: ``main(**kwargs)`` in this process, rank 0 of 1 (the
  reference's own local mode);
- ``np <= -2``: ``-np`` worker processes on this host; they may share a
  card (then over gloo) or run on the CPU where there is none;
- ``np >= 1``: ``np`` workers, one a task slot: a Spark barrier job of
  ``np`` tasks when a SparkSession is active, else one worker a CUDA
  card of this host or of the hosts of ``launcher.HOSTS`` (remote ones
  through a remote shell); NCCL for CUDA tensors. Fails fast when
  ``np`` exceeds the slots in total, and waits while other jobs' gangs
  hold them (:mod:`sparkdl_tpu_torch.horovod.launcher`);
- ``np == 0``: deprecated, every slot.

In every mode ``main`` may ``import horovod.torch as hvd`` (the
reference's headline use): inside the run that name is
:mod:`sparkdl_tpu_torch.compat.horovod_torch`, bound for the length of
the call where ``main`` runs in this process.

A gang (``np != -1``) runs under the supervisor
(:mod:`sparkdl_tpu_torch.horovod.supervisor`): with its ``policy`` at the
default a failed gang raises; with ``max_retries > 0`` a gang whose
failure is transient (a rank killed by a signal, a rendezvous timeout, a
rank whose traceback is the distributed runtime failing) is launched
again, and a user-code exception never is. The resume contract: a
relaunched worker's
:func:`~sparkdl_tpu_torch.horovod.restart_context` gives its attempt
number and the newest step committed under the policy's ``resume_dir``
by a :class:`~sparkdl_tpu_torch.utils.checkpoint.TrainCheckpointer`;
``main`` restores that step and continues after it. ``np == -1`` runs
once, unsupervised.

The pre-flight lint of the JAX package (its ``analysis`` passes over
jaxprs) has no PyTorch counterpart.
"""

import logging

_LOG_VERBOSITY_VALUES = ("all", "log_callback_only")


class HorovodRunner:
    """HorovodRunner runs distributed deep learning training jobs on a
    gang of worker processes joined by ``torch.distributed``
    (:mod:`sparkdl_tpu_torch.hvd`)."""

    def __init__(self, *, np, driver_log_verbosity="log_callback_only"):
        """
        :param np: number of parallel processes to use for the Horovod job.

            - If np >= 1, launch np workers, each bound to its own CUDA
              card (one task slot <-> one card, reference
              ``runner_base.py:44-45``): as a Spark barrier job under an
              active SparkSession, else from this host. They start all
              together; if np is greater than the slots in total, the
              job fails fast, and while slots are busy it waits
              (reference ``runner_base.py:54-58``). np = 0 (every slot)
              is deprecated (reference ``README.md:57-61``).
            - If np < 0, spawn ``-np`` subprocesses on this host
              (reference ``runner_base.py:48-53``); np = -1 runs
              ``main`` in the current process.

        :param driver_log_verbosity: driver log verbosity for np >= 0:
            "all" streams every worker's stdout and stderr to the
            driver; the default "log_callback_only" prints only the
            messages sent with
            :func:`sparkdl_tpu_torch.horovod.log_to_driver`. Local
            gangs (np < 0) always stream (reference ``README.md:44-47``).
            Every worker's output also goes to the job's log files.
        """
        if not isinstance(np, int) or isinstance(np, bool):
            raise TypeError(
                f"HorovodRunner np must be an int, got {type(np).__name__}: {np!r}"
            )
        if driver_log_verbosity not in _LOG_VERBOSITY_VALUES:
            raise ValueError(
                "driver_log_verbosity must be one of "
                f"{_LOG_VERBOSITY_VALUES}, got {driver_log_verbosity!r}"
            )
        self.num_processor = np
        self.driver_log_verbosity = driver_log_verbosity

    def run(self, main, **kwargs):
        """Runs a Horovod training job invoking main(**kwargs).

        ``main`` and the keyword arguments are serialized with
        cloudpickle and sent to every worker (reference
        ``runner_base.py:82-83``); a large closure makes the job slow to
        start, so load data inside ``main``.

        :return: return value of rank 0's ``main`` (reference
            ``runner_base.py:93-95``); in-process for np = -1.
        """
        np_arg = self.num_processor
        if np_arg == -1:
            # the gang path's opt-in pre-flight: local mode is where users
            # iterate before paying for cards
            from sparkdl_tpu_torch.analysis.preflight import preflight_lint

            preflight_lint(main, kwargs)
            logging.getLogger("HorovodRunner").warning(
                "HorovodRunner is running in local mode (np=-1): main() is "
                "invoked in the current process with a single worker. Use "
                "np<=-2 for a local multi-process gang or np>0 for a "
                "gang with one worker a CUDA card."
            )
            from sparkdl_tpu_torch.compat import horovod_torch
            from sparkdl_tpu_torch.hvd import _state

            # import horovod.torch gives the port for the call only
            with _state.local_mode(), horovod_torch.bound():
                return main(**kwargs)
        from sparkdl_tpu_torch.horovod.launcher import launch_gang

        return launch_gang(np=np_arg, main=main, kwargs=kwargs,
                           driver_log_verbosity=self.driver_log_verbosity)
