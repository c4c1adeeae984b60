"""Port parity: SET_ATTR (``master/filesystem.py::set_attr``, the
``set_attr`` journal op, ``master/server.py``'s handler under the
superuser gate, ``client/fs_client.py::set_attr``) of
``curvine_tpu_torch``, against the JAX package on the CPU.

Mirrors the set_attr half of ``tests/test_cluster.py::
test_set_attr_and_symlink`` on the port's own cluster (the symlink half
stays refused: ROADMAP §A item 4). Holds a seeded sequence of
``SetAttrOpts`` (owner, group, mode, replicas, TTL fields, times, xattrs
and the ``ec`` storage class, valid and not) applied by both packages'
``MasterFilesystem`` to the same statuses, errors and journal bytes, and
refuses a caller who is not the superuser, a bad EC profile, a missing
path and a write under a read-only mount by name; the attributes
outlive a master restart."""

import os
import random

import pytest

from curvine_tpu.common import errors as jerr
from curvine_tpu.common.types import SetAttrOpts as JaxSetAttrOpts
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import SetAttrOpts
from test_torch_master import _Both, _masked
from torch_cluster import PortCluster


async def test_set_attr(tmp_path):
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        await c.write_all("/s", b"data")
        await c.meta.set_attr("/s", SetAttrOpts(owner="bob", mode=0o600,
                                                add_x_attr={"k": b"v"}))
        st = await c.meta.file_status("/s")
        assert st.owner == "bob" and st.mode == 0o600
        assert st.x_attr == {"k": b"v"}


def _opts_wire(rng: random.Random) -> dict:
    """One seeded SetAttrOpts in wire form: a few fields set, the rest
    left alone (None), an EC profile valid or not."""
    w = SetAttrOpts().to_wire()
    pick = rng.sample(["replicas", "owner", "group", "mode", "ttl_ms",
                       "ttl_action", "add_x_attr", "remove_x_attr",
                       "atime", "mtime", "ec"], rng.randint(1, 4))
    for k in pick:
        w[k] = {"replicas": lambda: rng.randint(1, 3),
                "owner": lambda: rng.choice(["u1", "u2"]),
                "group": lambda: rng.choice(["g1", "g2"]),
                "mode": lambda: rng.choice([0o600, 0o644, 0o755]),
                "ttl_ms": lambda: rng.randint(0, 10_000),
                "ttl_action": lambda: rng.randint(0, 2),
                "add_x_attr": lambda: {rng.choice("abc"): rng.randbytes(2)},
                "remove_x_attr": lambda: [rng.choice("abc")],
                "atime": lambda: rng.randint(1, 1 << 40),
                "mtime": lambda: rng.randint(1, 1 << 40),
                "ec": lambda: rng.choice(["rs-2-1", "rs-6-3", "",
                                          "rs-0-1", "xor"])}[k]()
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_attr_matches_the_reference(tmp_path, monkeypatch, seed):
    """A seeded sequence of SET_ATTRs on files and directories (and on a
    missing path) through both packages' masters: the same result or
    error code at each, the same statuses after, and the same journal
    bytes (set_attr entries carry the wire opts, no time)."""
    rng = random.Random(seed)
    both = _Both(tmp_path, monkeypatch)
    paths = ["/d", "/d/f", "/d/e/g", "/h"]
    both("mkdir", "/d/e")
    for p in ("/d/f", "/d/e/g", "/h"):
        both("create_file", p, client_name="c1")
        both("complete_file", p, 0)
    for _ in range(60):
        path = rng.choice(paths + ["/missing"])
        w = _opts_wire(rng)
        out = []
        for fs, cls, errs in ((both.jax, JaxSetAttrOpts, jerr),
                              (both.port, SetAttrOpts, err)):
            try:
                fs.set_attr(path, cls.from_wire(dict(w)))
                out.append(("ok", _masked(fs.file_status(path))))
            except errs.CurvineError as e:
                out.append(("error", int(e.code)))
        assert out[0] == out[1], (path, w, out)
    # the times the creates stamped are masked above (the two packages
    # read their clocks a different number of times); set last, they
    # compare whole
    for i, p in enumerate(paths):
        both.jax.set_attr(p, JaxSetAttrOpts(atime=i + 1, mtime=i + 2))
        both.port.set_attr(p, SetAttrOpts(atime=i + 1, mtime=i + 2))
        assert both.jax.file_status(p).to_wire() == \
            both.port.file_status(p).to_wire()
    both.jax.journal.close()
    both.port.journal.close()
    jdir, pdir = both.jax.journal.dir, both.port.journal.dir
    names = sorted(n for n in os.listdir(jdir) if n.startswith("edits-"))
    assert names == sorted(n for n in os.listdir(pdir)
                           if n.startswith("edits-"))
    for name in names:
        assert open(os.path.join(jdir, name), "rb").read() == \
            open(os.path.join(pdir, name), "rb").read(), name


async def test_set_attr_refusals(tmp_path):
    """A caller who is not the superuser is refused with
    PermissionDenied, a bad EC profile with InvalidArgument before any
    entry is journaled, a missing path with FileNotFound, and a write
    under a read-only mount with Unsupported; the file keeps its
    attributes."""
    ufs = tmp_path / "u"
    ufs.mkdir()
    (ufs / "a.bin").write_bytes(b"a" * 10)
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        await c.write_all("/f", b"x")
        before = pc.master.fs.file_status("/f").to_wire()
        seq = pc.master.fs.journal.seq
        other = pc.client()
        other.meta.user, other.meta.groups = "mallory", ["mallory"]
        with pytest.raises(err.PermissionDenied):
            await other.meta.set_attr("/f", SetAttrOpts(mode=0o777))
        with pytest.raises(err.InvalidArgument, match="rs-9"):
            await c.meta.set_attr("/f", SetAttrOpts(ec="rs-9"))
        with pytest.raises(err.FileNotFound):
            await c.meta.set_attr("/nope", SetAttrOpts(mode=0o600))
        assert pc.master.fs.journal.seq == seq
        assert pc.master.fs.file_status("/f").to_wire() == before
        await c.meta.mount("/m", f"file://{ufs}", access_mode="r")
        with pytest.raises(err.Unsupported, match="read-only"):
            await c.meta.set_attr("/m", SetAttrOpts(mode=0o600))


async def test_set_attr_outlives_a_master_restart(tmp_path):
    """The set_attr entries replay: the attributes, the TTL fields and
    the EC class come back after a restart on the journal."""
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        await c.write_all("/r", b"r" * 100)
        await c.meta.set_attr("/r", SetAttrOpts(
            owner="o", group="g", mode=0o640, replicas=2, ttl_ms=60_000,
            ttl_action=1, atime=5, mtime=6, add_x_attr={"k": b"v"},
            ec="rs-4-2"))
        want = pc.master.fs.file_status("/r").to_wire()
        await pc.restart_master()
        got = pc.master.fs.file_status("/r").to_wire()
        assert got == want
        assert (got["owner"], got["mode"], got["replicas"], got["atime"],
                got["mtime"], got["storage_policy"]["ttl_ms"],
                got["storage_policy"]["ec"]) == \
            ("o", 0o640, 2, 5, 6, 60_000, "rs-4-2")
