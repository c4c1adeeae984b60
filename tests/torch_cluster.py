"""A cluster of the port's own master and workers, in the test's process
and on its event loop, for the port's CPU tests."""

import asyncio
import contextlib
import copy
import os

from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf, TierConf
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.worker.server import WorkerServer

MB = 1 << 20
BLOCK = 4 * MB


def _master_conf(tmp_path, **master) -> ClusterConf:
    conf = ClusterConf()
    mc = conf.master
    mc.rpc_port = 0
    mc.journal_dir = str(tmp_path / "journal")
    mc.worker_lost_timeout_ms = 30_000
    mc.heartbeat_check_ms = 200
    for k, v in master.items():
        setattr(mc, k, v)
    conf.client.block_size = BLOCK
    return conf


def _worker_conf(conf: ClusterConf, root: str) -> ClusterConf:
    wconf = copy.deepcopy(conf)
    wc = wconf.worker
    wc.hostname, wc.rpc_port, wc.heartbeat_ms = "127.0.0.1", 0, 200
    wc.promote_interval_ms = 0
    wc.tiers = [TierConf(storage_type="mem", dir=os.path.join(root, "mem"),
                         capacity=64 * MB)]
    return wconf


async def _await_live(m: MasterServer, n: int, timeout: float = 10.0):
    """Wait until the master lists ``n`` serving workers (LIVE, or
    draining: a decommission intent outlives a master restart)."""
    async def wait():
        while len(m.fs.workers.serving_workers()) < n:
            await asyncio.sleep(0.02)
    await asyncio.wait_for(wait(), timeout)


class PortCluster:
    """The port's master and ``workers`` of the port's workers, with a
    master restart on the same journal and port (the ``MiniCluster`` of
    the reference's tests); clients made by ``client()`` close with it."""

    def __init__(self, tmp_path, workers: int = 1, **master):
        self.tmp_path = tmp_path
        self.n_workers = workers
        self.conf = _master_conf(tmp_path, **master)
        self.workers: list[WorkerServer] = []
        self._clients: list[CurvineClient] = []

    async def __aenter__(self) -> "PortCluster":
        self.master = MasterServer(self.conf)
        await self.master.start()
        # a restart comes back on this port
        self.conf.master.rpc_port = self.master.rpc.port
        self.conf.client.master_addrs = [self.master.addr]
        try:
            for _ in range(self.n_workers):
                await self.add_worker(wait=False)
            await _await_live(self.master, self.n_workers)
        except BaseException:
            await self.__aexit__()
            raise
        return self

    async def __aexit__(self, *exc) -> None:
        for c in self._clients:
            await c.close()
        for w in self.workers:
            if w.rpc._lsock is not None:      # not stopped by the test
                await w.stop()
        await self.master.stop()

    async def add_worker(self, tiers: list[TierConf] | None = None,
                         wait: bool = True) -> WorkerServer:
        """One more of the port's workers (a 64 MiB mem tier under its own
        directory, or ``tiers``), started and, with ``wait``, live at the
        master."""
        wconf = _worker_conf(self.conf,
                             str(self.tmp_path / f"w{len(self.workers)}"))
        if tiers is not None:
            wconf.worker.tiers = tiers
        w = WorkerServer(wconf)
        await w.start()
        self.workers.append(w)
        if wait:
            async def live():
                while w.worker_id not in {
                        x.address.worker_id
                        for x in self.master.fs.workers.live_workers()}:
                    await asyncio.sleep(0.02)
            await asyncio.wait_for(live(), 10.0)
        return w

    def client(self) -> CurvineClient:
        c = _client(self.conf)
        self._clients.append(c)
        return c

    async def restart_master(self) -> None:
        await self.master.stop()
        self.master = MasterServer(self.conf)
        await self.master.start()
        await _await_live(self.master, self.n_workers)


@contextlib.asynccontextmanager
async def _cluster(tmp_path, workers: int = 1, **master):
    """(master, [workers], the cluster's conf) of a ``PortCluster``."""
    async with PortCluster(tmp_path, workers, **master) as c:
        yield c.master, c.workers, c.conf


def _client(conf: ClusterConf) -> CurvineClient:
    return CurvineClient(copy.deepcopy(conf))


class PortRaftCluster:
    """``n`` of the port's masters under raft, in the test's process, and
    spare ports for learners: the ``MiniRaftCluster`` of the reference's
    tests (``curvine_tpu/testing/cluster.py:126``), with kill, restart,
    wipe and transfer, and port workers that heartbeat every master. A
    port bound meanwhile by another process (EADDRINUSE) restarts the
    whole cluster on fresh ports and fresh directories."""

    def __init__(self, tmp_path, n: int = 3, spares: int = 0,
                 election_timeout=(150, 300), heartbeat_ms: int = 50,
                 scan_interval_s: float = 5.0, **master):
        self.tmp_path = tmp_path
        self.n = n
        self.spares = spares
        self.election_timeout = election_timeout
        self.heartbeat_ms = heartbeat_ms
        self.scan_interval_s = scan_interval_s
        self.master_fields = master
        self.attempt = 0
        self._probe_ports()
        self.masters: dict[int, MasterServer] = {}
        self.confs: dict[int, ClusterConf] = {}
        self.workers: list[WorkerServer] = []
        self._next_id = n + 1
        self._clients: list[CurvineClient] = []

    def _probe_ports(self) -> None:
        import socket
        socks = []
        for _ in range(self.n + self.spares):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        self.ports = [s.getsockname()[1] for s in socks]
        self.addrs = [f"127.0.0.1:{p}" for p in self.ports]
        for s in socks:
            s.close()

    def journal_dir(self, node_id: int) -> str:
        return str(self.tmp_path / f"a{self.attempt}-j{node_id}")

    def _conf_for(self, node_id: int, learner: bool = False) -> ClusterConf:
        conf = _master_conf(self.tmp_path, **self.master_fields)
        mc = conf.master
        mc.hostname = "127.0.0.1"
        mc.rpc_port = self.ports[node_id - 1]
        mc.journal_dir = self.journal_dir(node_id)
        # a learner's list holds its own slot, so that it knows its address
        mc.raft_peers = self.addrs[:max(self.n, node_id)]
        mc.raft_node_id = node_id
        mc.raft_learner = learner
        conf.client.master_addrs = self.addrs[:self.n]
        return conf

    async def _start_node(self, node_id: int,
                          learner: bool = False) -> MasterServer:
        conf = self.confs.get(node_id) or self._conf_for(node_id, learner)
        self.confs[node_id] = conf
        m = MasterServer(conf)
        m.raft.election_timeout = self.election_timeout
        m.raft.heartbeat_ms = self.heartbeat_ms
        m.replication.scan_interval_s = self.scan_interval_s
        await m.start()
        self.masters[node_id] = m
        return m

    async def start(self) -> "PortRaftCluster":
        import errno
        for attempt in range(3):
            self.attempt = attempt
            try:
                for nid in range(1, self.n + 1):
                    await self._start_node(nid)
                return self
            except OSError as e:
                if e.errno != errno.EADDRINUSE or attempt == 2:
                    raise
                await self.stop()
                self.confs.clear()
                self._probe_ports()
        return self

    async def __aenter__(self) -> "PortRaftCluster":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def live(self) -> list[MasterServer]:
        return [m for m in self.masters.values() if m.rpc._lsock is not None]

    def leader(self) -> MasterServer | None:
        leaders = [m for m in self.live() if m.raft.is_leader]
        return leaders[0] if len(leaders) == 1 else None

    async def wait_leader(self, timeout: float = 15.0,
                          among=None) -> MasterServer:
        """The one leader among ``among`` (default: the live masters)."""
        async def wait():
            while True:
                pool = self.live() if among is None else among
                leaders = [m for m in pool if m.raft.is_leader]
                if len(leaders) == 1:
                    return leaders[0]
                await asyncio.sleep(0.02)
        return await asyncio.wait_for(wait(), timeout)

    def client(self, **client_fields) -> CurvineClient:
        conf = ClusterConf()
        conf.client.master_addrs = list(self.addrs[:self.n])
        conf.client.block_size = BLOCK
        conf.client.conn_retry_max = 10
        conf.client.conn_retry_base_ms = 100
        conf.client.rpc_timeout_ms = 5_000
        for k, v in client_fields.items():
            setattr(conf.client, k, v)
        c = CurvineClient(conf)
        self._clients.append(c)
        return c

    async def _admin(self) -> CurvineClient:
        if not self._clients:
            self.client()
        return self._clients[0]

    async def add_learner(self) -> int:
        """Start the next spare as a learner and journal its addition on
        the leader; its promotion follows once it has caught up."""
        node_id = self._next_id
        if node_id > len(self.addrs):
            raise RuntimeError("no spare ports left for a new learner")
        self._next_id += 1
        await self._start_node(node_id, learner=True)
        c = await self._admin()
        await c.meta.raft_member_change("add_learner", node_id,
                                        self.addrs[node_id - 1])
        return node_id

    async def wait_promoted(self, node_id: int,
                            timeout: float = 30.0) -> None:
        """Until every live node counts ``node_id`` among the voters."""
        async def wait():
            while not all(node_id in m.raft.voters for m in self.live()):
                await asyncio.sleep(0.02)
        await asyncio.wait_for(wait(), timeout)

    async def remove_node(self, node_id: int, stop: bool = True) -> None:
        c = await self._admin()
        await c.meta.raft_member_change("remove", node_id)
        if stop and node_id in self.masters:
            m = self.masters.pop(node_id)
            if m.rpc._lsock is not None:
                await m.stop()

    async def transfer(self, target: int | None = None) -> int:
        c = await self._admin()
        return await c.meta.raft_transfer(target)

    async def kill(self, node_id: int) -> None:
        m = self.masters.pop(node_id, None)
        if m is not None and m.rpc._lsock is not None:
            await m.stop()

    async def restart(self, node_id: int) -> MasterServer:
        await self.kill(node_id)
        return await self._start_node(node_id)

    def wipe(self, node_id: int) -> None:
        """Remove a stopped node's journal and KV directories."""
        import shutil
        assert node_id not in self.masters, "stop the node first"
        d = self.journal_dir(node_id)
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d + "-meta", ignore_errors=True)

    async def add_worker(self) -> WorkerServer:
        """A port worker whose master list is every master; it reports
        its blocks in full every 300 ms, so that the followers learn the
        replicas' locations too."""
        conf = self._conf_for(1)
        conf.client.master_addrs = list(self.addrs[:self.n])
        wconf = _worker_conf(conf, str(self.tmp_path /
                                       f"w{len(self.workers)}"))
        wconf.worker.block_report_interval_ms = 300
        w = WorkerServer(wconf)
        await w.start()
        self.workers.append(w)
        return w

    async def stop(self) -> None:
        for c in self._clients:
            await c.close()
        self._clients.clear()
        for w in self.workers:
            if w.rpc._lsock is not None:
                await w.stop()
        self.workers.clear()
        for m in list(self.masters.values()):
            if m.rpc._lsock is not None:
                await m.stop()
        self.masters.clear()


class Partition:
    """Drop a master's raft traffic, both ways: requests reaching its
    server go unanswered (the caller times out), and its raft client's
    dials fail. ``p`` is the share dropped (1.0: a partition), drawn
    from a seeded generator."""

    def __init__(self, m: MasterServer, p: float = 1.0, seed: int = 0):
        import random
        from curvine_tpu_torch.common import errors as err
        self.m = m
        rng = random.Random(seed)
        dispatch, get = m.rpc._dispatch, m.raft.pool.get

        async def drop_in(msg, conn):
            if rng.random() < p:
                return
            await dispatch(msg, conn)

        async def drop_out(addr):
            if rng.random() < p:
                raise err.ConnectError(f"dropped: {addr}")
            return await get(addr)

        m.rpc._dispatch = drop_in
        m.raft.pool.get = drop_out

    def heal(self) -> None:
        del self.m.rpc._dispatch
        del self.m.raft.pool.get
