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
