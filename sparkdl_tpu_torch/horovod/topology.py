"""Gang topology: where each rank of a gang sits.

Counterpart of ``sparkdl_tpu/horovod/topology.py``. The reference's slots
live on the task nodes (reference ``runner_base.py:44-45``, ``:54-55``),
so a gang is a hosts x slots grid:

- :func:`parse_hosts` reads an mpirun-style hosts spec
  (``"h1:4,h2:4"``, the launcher's ``HOSTS`` setting);
- :class:`Placement` maps a global rank to its host, its local rank and
  its host's local size, hosts filled in order; the launcher exports the
  local rank and size as ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, and a
  rank of a card gang binds ``cuda:LOCAL_RANK`` (as the JAX package
  binds its chip by local rank);
- :func:`is_local_host` decides between a local process and the remote
  shell for each host of a spec;
- :func:`placement_from_task_hosts` lays out a gang that Spark already
  scheduled, hosts possibly interleaved.

The TPU pod-slice variables of the JAX ``env_for_rank`` have no
counterpart: a card needs no process grid.
"""

import functools

_LOOPBACK = ("localhost", "127.0.0.1", "::1")


def parse_hosts(spec):
    """``"h1:4,h2:4"`` -> ``[("h1", 4), ("h2", 4)]``; a bare host means
    one slot. Raises ValueError on malformed entries."""
    hosts = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, sep, slots = entry.partition(":")
        if not host:
            raise ValueError(f"empty host in host spec {spec!r}")
        try:
            n = int(slots) if sep else 1
        except ValueError:
            raise ValueError(
                f"bad slot count {slots!r} for host {host!r} in {spec!r}")
        if n < 1:
            raise ValueError(f"host {host!r} has {n} slots in {spec!r}")
        hosts.append((host, n))
    if not hosts:
        raise ValueError(f"no hosts in host spec {spec!r}")
    return hosts


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

    def first(self, n):
        """The placement of this one's first ``n`` ranks: the hosts they
        fill, the last one with the slots it takes."""
        hosts, left = [], n
        for host, slots in self.hosts:
            if left <= 0:
                break
            hosts.append((host, min(slots, left)))
            left -= slots
        return Placement(hosts)

    def host_index(self, rank):
        return self._host_of[rank]

    def host(self, rank):
        return self.hosts[self._host_of[rank]][0]

    def local_rank(self, rank):
        return self._local_of[rank]

    def local_size(self, rank):
        return self.hosts[self._host_of[rank]][1]


@functools.lru_cache(maxsize=64)
def _addressable(host):
    """A form of ``host`` that peer machines can dial: loopback aliases
    become this machine's routable IP, anything else passes through (and
    so does the alias when no routable address can be found: same-host
    peers still work, remote ones fail naming the address). Cached, so a
    multi-NIC host whose default route flaps mid-launch hands every rank
    the same address."""
    if host in _LOOPBACK:
        from sparkdl_tpu_torch.horovod.control_plane import routable_host_ip

        try:
            return routable_host_ip()
        except OSError:
            return host
    return host


@functools.lru_cache(maxsize=256)
def is_local_host(host):
    """True when ``host`` names this machine: loopback, its hostname or
    fqdn, or a name that resolves onto one of its addresses. An
    unresolvable name is not local: the remote transport then fails
    loudly instead of a launch quietly collapsing onto this machine.
    Cached: one launch asks for every rank, and a flaky resolver must
    not answer two ranks of one host differently."""
    import socket

    if host in _LOOPBACK:
        return True
    names = {socket.gethostname()}
    try:
        names.add(socket.getfqdn())
    except OSError:
        pass
    if host in names:
        return True
    try:
        host_ips = {ai[4][0] for ai in socket.getaddrinfo(host, None)}
    except OSError:
        return False
    if any(ip.startswith("127.") or ip == "::1" for ip in host_ips):
        return True
    local_ips = set()
    for n in names:
        try:
            local_ips |= {ai[4][0] for ai in socket.getaddrinfo(n, None)}
        except OSError:
            pass
    # the hostname alone misses a NIC address on a Debian-style
    # /etc/hosts (hostname -> 127.0.1.1)
    from sparkdl_tpu_torch.horovod.control_plane import routable_host_ip

    try:
        local_ips.add(routable_host_ip())
    except OSError:
        pass
    return bool(host_ips & local_ips)


def placement_from_task_hosts(host_of_rank):
    """The placement of a gang already scheduled (Spark barrier mode):
    ``host_of_rank[r]`` is the host that runs rank r. Local ranks go by
    order of appearance within each host, so every task computes the
    same layout however the hosts interleave."""
    seen = {}
    locals_ = []
    for h in host_of_rank:
        locals_.append(seen.get(h, 0))
        seen[h] = locals_[-1] + 1
    p = Placement(list(seen.items()))
    # the order-derived tables assume hosts in runs: [h0, h1, h0, h1]
    # interleaves
    p._host_of = [list(seen).index(h) for h in host_of_rank]
    p._local_of = locals_
    return p
