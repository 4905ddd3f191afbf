"""Gang topology: where each rank of a gang sits.

Counterpart of ``sparkdl_tpu/horovod/topology.py``, single-host part
only: :class:`Placement` maps a global rank to its host, its local rank
and its host's local size, hosts filled in order. The launcher builds
``Placement.single_host(n)`` for every gang and exports the local rank
and size as ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``. Host specs, remote
hosts and the TPU pod-slice variables are not ported (they come with the
Spark and ssh backends).
"""


class Placement:
    """Rank layout over ``[(host, slots), ...]``, hosts filled in order:
    ranks 0..s0-1 on host 0, the next s1 on host 1, ..."""

    def __init__(self, hosts):
        self.hosts = list(hosts)
        self.total_slots = sum(n for _, n in self.hosts)
        self._host_of = []
        self._local_of = []
        for hi, (_, n) in enumerate(self.hosts):
            for li in range(n):
                self._host_of.append(hi)
                self._local_of.append(li)

    @classmethod
    def single_host(cls, slots, host="localhost"):
        return cls([(host, slots)])

    def host(self, rank):
        return self.hosts[self._host_of[rank]][0]

    def local_rank(self, rank):
        return self._local_of[rank]

    def local_size(self, rank):
        return self.hosts[self._host_of[rank]][1]
