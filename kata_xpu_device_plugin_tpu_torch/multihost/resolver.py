"""Worker-id and hostname resolution across hosts (counterpart of
``kata_xpu_device_plugin_tpu/multihost/resolver.py``, the same rules).

Sources, in precedence order (first complete answer wins):

1. **Explicit config**: ``--worker-id`` + ``--worker-hostnames`` (or their
   ``KATA_TPU_*`` env forms). The operator's word is final.
2. **Node env**: ``TPU_WORKER_ID`` + ``TPU_WORKER_HOSTNAMES`` already set on
   the node (the names the daemon hands the guest, ``constants.py``).
3. **Metadata directory**: files named after the metadata attributes,
   ``agent-worker-number`` (this host's id) and ``worker-network-endpoints``
   (the ordered endpoint list), written by a metadata agent or projected by
   the DaemonSet.
4. **Derived**: given only a peer hostname list without an id, every host
   takes its own index in that list. Each source's order is identical on
   every host, so the assignment needs no coordinator and is stable across
   restarts. :func:`canonical_order` is there for unordered host lists.

Whatever resolves is persisted to a state file; when every live source
fails later (the metadata agent down after a pod restart), the persisted
identity is reused, and when they disagree the live answer wins and the
drift is logged. The ``accelerator-type`` attribute of the JAX package is
not read: a GPU host has no type that fixes its host count, so the manager
always passes ``num_hosts_hint=0``.
"""
from __future__ import annotations

import json
import os
import re
import socket
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

from ..constants import ENV_WORKER_HOSTNAMES, ENV_WORKER_ID
from ..utils import log

LOG = log.get("multihost")

# Metadata attribute names, read as files of the metadata directory.
ATTR_WORKER_NUMBER = "agent-worker-number"
ATTR_WORKER_ENDPOINTS = "worker-network-endpoints"

STATE_FILE = "worker-identity.json"


@dataclass(frozen=True)
class SliceMembership:
    """This host's resolved identity among its workers."""

    worker_id: int
    hostnames: tuple[str, ...]  # canonical order; index == worker id
    source: str  # "config" | "env" | "metadata" | "derived" | "state"

    @property
    def num_hosts(self) -> int:
        return len(self.hostnames) or 1


_ORDINAL_RE = re.compile(r"^(.*?)(\d+)$")


def _sort_key(hostname: str) -> tuple[str, int]:
    """Numeric-suffix-aware ordering: ``…-w-10`` sorts after ``…-w-9``
    (lexicographic order would scramble ids past 9 hosts)."""
    m = _ORDINAL_RE.match(hostname)
    if m:
        return (m.group(1), int(m.group(2)))
    return (hostname, -1)


def canonical_order(hostnames: Sequence[str]) -> tuple[str, ...]:
    """The canonical hostname ordering (dedup + ordinal sort)."""
    return tuple(sorted(dict.fromkeys(hostnames), key=_sort_key))


def parse_worker_network_endpoints(raw: str) -> tuple[str, ...]:
    """Parse the ``worker-network-endpoints`` attribute: comma-separated
    workers, each a bare hostname or IP or colon-joined fields
    (``<id>:<ip>:<port>``). The attribute's order is the worker order,
    preserved, not re-sorted."""
    out = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        out.append(_pick_host(entry.split(":")))
    return tuple(out)


_IPV4 = re.compile(r"\d+\.\d+\.\d+\.\d+")


def _pick_host(fields: Sequence[str]) -> str:
    """Best addressable field of one endpoint: hostname > IPv4 > first."""
    for f in fields:
        if f and not f.isdigit() and not _IPV4.fullmatch(f):
            return f
    for f in fields:
        if _IPV4.fullmatch(f):
            return f
    return fields[0]


def _match_self(hostnames: Sequence[str], hostname: str) -> Optional[int]:
    """Index of this host in the list: an exact match first, then a
    short-name match (metadata lists FQDNs while the pod sees the short
    hostname). The short-name match never applies to IPs: '10.0.0.9' must
    not match '10.0.0.1' through their shared first octet."""
    for i, h in enumerate(hostnames):
        if h == hostname:
            return i
    if _IPV4.fullmatch(hostname):
        return None
    short = hostname.split(".")[0]
    for i, h in enumerate(hostnames):
        if not _IPV4.fullmatch(h) and h.split(".")[0] == short:
            return i
    return None


def _read_attr(metadata_dir: str, name: str) -> Optional[str]:
    try:
        with open(os.path.join(metadata_dir, name)) as f:
            return f.read().strip()
    except OSError:
        return None


# ----- state persistence ---------------------------------------------------


def _state_path(state_dir: str) -> str:
    return os.path.join(state_dir, STATE_FILE)


def load_state(state_dir: str) -> Optional[SliceMembership]:
    try:
        with open(_state_path(state_dir)) as f:
            raw = json.load(f)
        return SliceMembership(
            worker_id=int(raw["worker_id"]),
            hostnames=tuple(raw["hostnames"]),
            source="state",
        )
    except (OSError, KeyError, ValueError, TypeError):
        return None


def clear_state(state_dir: str) -> None:
    try:
        os.remove(_state_path(state_dir))
    except OSError:
        pass


def save_state(state_dir: str, mem: SliceMembership) -> None:
    try:
        os.makedirs(state_dir, exist_ok=True)
        tmp = _state_path(state_dir) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"worker_id": mem.worker_id, "hostnames": list(mem.hostnames)}, f)
        os.replace(tmp, _state_path(state_dir))
    except OSError:
        LOG.warning("could not persist worker identity to %s", state_dir)


# ----- resolution ----------------------------------------------------------


def resolve_membership(
    env: Optional[Mapping[str, str]] = None,
    *,
    hostname: Optional[str] = None,
    explicit_worker_id: int = -1,
    explicit_hostnames: Sequence[str] = (),
    metadata_dir: str = "",
    state_dir: str = "",
    num_hosts_hint: int = 0,
    state_readonly: bool = False,
    defer_save: bool = False,
) -> Optional[SliceMembership]:
    """Resolve this host's membership, or None for a single-host node.

    Returns None only when no source mentions peers at all: the node is a
    standalone host and the default ``worker_id=0`` topology stands. A
    non-zero ``num_hosts_hint`` guards the persisted-state fallback (a
    persisted multi-host identity on a node whose hardware says otherwise is
    a leftover, not an outage); the GPU manager has no such hint and passes 0.
    """
    env = os.environ if env is None else env
    hostname = hostname or env.get("HOSTNAME") or socket.gethostname()

    mem = (
        _from_config(explicit_worker_id, explicit_hostnames, hostname)
        or from_env(env, hostname)
        or _from_metadata(metadata_dir, hostname)
    )
    if mem is None and explicit_worker_id >= 0:
        # Id pinned but no source resolved a membership (nothing lists peers,
        # or the metadata entries don't self-match); peers may merge in below.
        mem = SliceMembership(explicit_worker_id, (), "config")
    if mem is not None and explicit_worker_id >= 0 and mem.source != "config":
        # --worker-id without --worker-hostnames: the operator pins the id,
        # the hostname list still comes from whichever source has it.
        if mem.hostnames and explicit_worker_id >= len(mem.hostnames):
            LOG.warning(
                "--worker-id %d exceeds the %d-host list from %s; honoring it anyway",
                explicit_worker_id,
                len(mem.hostnames),
                mem.source,
            )
        mem = SliceMembership(explicit_worker_id, mem.hostnames, "config")
    if mem is not None and not mem.hostnames:
        # A bare id answers "who am I" but not "who else is there": a later
        # source (or the persisted state during an outage) may still know
        # the peer list; the resolved id stays authoritative.
        peers = _metadata_hostnames(metadata_dir)
        if not peers and state_dir and (st := load_state(state_dir)) is not None:
            # Persisted peers are trusted only when they corroborate the
            # live id and don't contradict a topology hint: a node reused
            # elsewhere must not resurrect a deleted job's peer list.
            if num_hosts_hint and st.num_hosts != num_hosts_hint:
                LOG.warning(
                    "discarding persisted peer list (%d hosts): this node's "
                    "topology implies %d host(s)",
                    st.num_hosts,
                    num_hosts_hint,
                )
                if not state_readonly:
                    clear_state(state_dir)
            elif st.worker_id == mem.worker_id:
                peers = st.hostnames
        if peers and mem.worker_id >= len(peers):
            LOG.warning(
                "worker id %d is not addressable in the %d-host peer list %s; "
                "ignoring the peers",
                mem.worker_id,
                len(peers),
                peers,
            )
            peers = ()
        if peers:
            mem = SliceMembership(mem.worker_id, peers, mem.source)

    if mem is None:
        if state_dir and (persisted := load_state(state_dir)) is not None:
            if num_hosts_hint and persisted.num_hosts != num_hosts_hint:
                LOG.warning(
                    "discarding persisted identity (id=%d, %d hosts): this "
                    "node's topology implies %d host(s)",
                    persisted.worker_id,
                    persisted.num_hosts,
                    num_hosts_hint,
                )
                if not state_readonly:
                    clear_state(state_dir)
                return None
            LOG.info(
                "no live identity source; reusing persisted worker id %d",
                persisted.worker_id,
            )
            return persisted
        return None

    if not defer_save and not state_readonly:
        persist_membership(state_dir, mem)
    return mem


def persist_membership(state_dir: str, mem: SliceMembership) -> None:
    """Commit an accepted membership to the state file (drift-aware, a
    no-op when unchanged). A caller that validates further resolves with
    ``defer_save=True`` and calls this only on acceptance."""
    if not state_dir or not mem.hostnames:
        # Hostname-less memberships are never persisted: they carry nothing a
        # restart couldn't re-derive, and must not clobber a complete
        # identity saved while the metadata source was up.
        return
    prior = load_state(state_dir)
    if prior is not None and (
        prior.worker_id != mem.worker_id or prior.hostnames != mem.hostnames
    ):
        LOG.warning(
            "worker identity drifted (was id=%d/%d hosts, now id=%d/%d hosts) "
            "— the job was likely recreated",
            prior.worker_id,
            prior.num_hosts,
            mem.worker_id,
            mem.num_hosts,
        )
    if prior is None or (prior.worker_id, prior.hostnames) != (
        mem.worker_id,
        mem.hostnames,
    ):
        save_state(state_dir, mem)


def _from_config(
    worker_id: int, hostnames: Sequence[str], hostname: str
) -> Optional[SliceMembership]:
    """Operator-supplied flags. Order is preserved, not canonicalized: with
    an explicit ``--worker-id`` each host's position in the list is the
    operator's id assignment."""
    if not hostnames:
        return None
    hosts = tuple(dict.fromkeys(hostnames))
    if worker_id >= 0:
        if worker_id >= len(hosts):
            LOG.error(
                "--worker-id %d out of range for %d worker-hostnames; ignoring flags",
                worker_id,
                len(hosts),
            )
            return None
        return SliceMembership(worker_id, hosts, "config")
    idx = _match_self(hosts, hostname)
    if idx is None:
        LOG.warning("this host %r is not in --worker-hostnames %s", hostname, hosts)
        return None
    return SliceMembership(idx, hosts, "derived")


def env_hostnames(env: Mapping[str, str]) -> tuple[str, ...]:
    """The ``TPU_WORKER_HOSTNAMES`` peer list, order preserved."""
    raw = env.get(ENV_WORKER_HOSTNAMES, "")
    return tuple(h.strip() for h in raw.split(",") if h.strip())


def from_env(env: Mapping[str, str], hostname: str = "") -> Optional[SliceMembership]:
    """Membership from the node's ``TPU_WORKER_ID``/``TPU_WORKER_HOSTNAMES``:
    the one parser of the two in this package (discovery delegates here)."""
    hosts = env_hostnames(env)
    raw_id = env.get(ENV_WORKER_ID, "").strip()
    has_id = raw_id.lstrip("-").isdigit() and int(raw_id) >= 0
    if not hosts:
        # A bare id is meaningful (and harmless) without a peer list.
        return SliceMembership(int(raw_id), (), "env") if has_id else None
    if has_id:
        wid = int(raw_id)
        if wid >= len(hosts):
            # A malformed node env must not propagate an unaddressable
            # id+peer pair into the CDI spec env.
            LOG.warning(
                "TPU_WORKER_ID %d is not an index into the %d-host "
                "TPU_WORKER_HOSTNAMES %s; ignoring the peer list",
                wid,
                len(hosts),
                hosts,
            )
            return SliceMembership(wid, (), "env")
        return SliceMembership(wid, hosts, "env")
    idx = _match_self(hosts, hostname)
    if idx is None:
        LOG.warning(
            "TPU_WORKER_HOSTNAMES is set but %r is not in it and TPU_WORKER_ID "
            "is absent — cannot derive a worker id (set --node-name?)",
            hostname,
        )
        return None
    return SliceMembership(idx, hosts, "derived")



def _metadata_hostnames(metadata_dir: str) -> tuple[str, ...]:
    """Just the peer list from metadata: usable even when this host's id
    comes from elsewhere (a bare ``TPU_WORKER_ID``)."""
    if not metadata_dir:
        return ()
    raw = _read_attr(metadata_dir, ATTR_WORKER_ENDPOINTS)
    return parse_worker_network_endpoints(raw) if raw else ()


def _from_metadata(metadata_dir: str, hostname: str) -> Optional[SliceMembership]:
    hosts = _metadata_hostnames(metadata_dir)
    if not hosts:
        return None
    raw_id = _read_attr(metadata_dir, ATTR_WORKER_NUMBER)
    if raw_id is not None and raw_id.isdigit():
        return SliceMembership(int(raw_id), hosts, "metadata")
    idx = _match_self(hosts, hostname)
    if idx is None:
        LOG.warning(
            "metadata lists workers %s but %r is not among them and no "
            "%s attribute exists — cannot derive a worker id",
            hosts,
            hostname,
            ATTR_WORKER_NUMBER,
        )
        return None
    return SliceMembership(idx, hosts, "derived")
