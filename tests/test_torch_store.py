"""The port's case-study stores (``repro_torch.store``: B+-tree, LSM tree,
du/cp, their graph plugins) against the reference's.

* the twins of ``tests/test_store.py``, of ``tests/test_plan.py``'s cases
  over the plugin graphs (du, cp, bptree_scan, bptree_load, lsm_get), of
  ``tests/test_futures.py``'s ``multi_get`` tests and of
  ``tests/test_system.py`` (its two wall-clock bounds unchanged), each run
  on both packages with the outputs compared;
* on-disk parity through ``OSDevice``: a B+-tree and an LSM store built
  from one seed by each package are byte-identical files, and a store
  written by either package opens in the other and answers every key as
  the dict oracle does.
"""

import errno
import os
import time

import numpy as np
import pytest
from _hypothesis_support import given, settings, st
from _torch_twins import J, T, plain, twin


# -- recordio ----------------------------------------------------------------
def test_recordio_roundtrip():
    def case(P):
        dev = P.MemDevice()
        w = P.RecordShardWriter(dev, "/s.rio", 16)
        recs = [bytes([i]) * 16 for i in range(10)]
        for r in recs:
            w.append(r)
        w.close()
        rd = P.RecordShardReader(dev, "/s.rio")
        assert len(rd) == 10
        got = [rd.read_record(i) for i in range(10)]
        assert got == recs
        with pytest.raises(IndexError):
            rd.read_record(10)
        return got, bytes(dev._files["/s.rio"])

    twin(case)


# -- B+-tree -------------------------------------------------------------------
def _bptree_oracle_case(P, n, degree, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(np.arange(10 * n, dtype=np.uint64), n, replace=False))
    vals = rng.integers(0, 2**60, n).astype(np.uint64)
    oracle = dict(zip(keys.tolist(), vals.tolist()))
    dev = P.MemDevice()
    t = P.BPTree(dev, "/t.db", degree=degree)
    t.bulk_load(keys, vals)
    for k in list(oracle)[:20]:
        assert t.search(int(k)) == oracle[k]
    assert t.search(int(keys[-1]) + 1) is None
    lo, hi = int(keys[0]), int(keys[min(n - 1, n // 2)])
    expect = sorted((k, v) for k, v in oracle.items() if lo <= k <= hi)
    got = t.scan(lo, hi)
    assert got == expect
    for k in list(oracle)[:5]:
        assert t.search_cold(int(k)) == oracle[k]
    return got, bytes(dev._files["/t.db"])


@settings(max_examples=15, deadline=None)
@given(n=st.integers(1, 400), degree=st.integers(4, 64), seed=st.integers(0, 99))
def test_bptree_matches_dict_oracle(n, degree, seed):
    twin(_bptree_oracle_case, n, degree, seed)


def test_bptree_reopen():
    def case(P):
        dev = P.MemDevice()
        keys = np.arange(100, dtype=np.uint64) * 3
        P.BPTree(dev, "/t.db", degree=16).bulk_load(keys, keys + 7)
        t2 = P.BPTree(dev, "/t.db").open()
        assert t2.degree == 16
        assert t2.search(30) == 37
        got = t2.scan(0, 500)
        assert len(got) == 100
        return t2.degree, t2.height, t2.nleaves, got

    twin(case)


def test_bptree_foreactor_scan_load_equivalence():
    def case(P):
        dev = P.MemDevice()
        keys = np.arange(3000, dtype=np.uint64) * 2
        vals = keys * 5 + 1
        fa = P.Foreactor(device=dev, backend="io_uring", depth=16)
        P.plugins.register_all(fa)
        t = P.BPTree(dev, "/fa.db", degree=50)
        load = fa.wrap("bptree_load", P.plugins.capture_bptree_load)(P.plugins.load_with_graph)
        load(t, keys, vals)
        t2 = P.BPTree(dev, "/fa.db").open()
        scan = fa.wrap("bptree_scan", P.plugins.capture_bptree_scan)(P.plugins.scan_with_graph)
        got = scan(t2, 100, 3000)
        assert got == [(int(k), int(v)) for k, v in zip(keys, vals) if 100 <= k <= 3000]
        fa.shutdown()
        return got, bytes(dev._files["/fa.db"])

    twin(case)


# -- LSM -------------------------------------------------------------------------
def _lsm_oracle_case(P, seed, limit):
    rng = np.random.default_rng(seed)
    dev = P.MemDevice()
    lsm = P.LSMTree(dev, "/db", memtable_limit_bytes=limit, l0_limit=3, fsync_writes=False)
    oracle = {}
    for i in range(1200):
        k = int(rng.integers(0, 300))
        if rng.random() < 0.1:
            lsm.delete(k)
            oracle[k] = None
        else:
            v = f"v{k}_{i}".encode()
            lsm.put(k, v)
            oracle[k] = v
    got = [lsm.get(k) for k in list(oracle)[:100]]
    assert got == [oracle[k] for k in list(oracle)[:100]]
    assert lsm.get(10**9) is None
    return got, [[t.path for t in lvl] for lvl in lsm.levels]


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 999), limit=st.sampled_from([1 << 12, 1 << 14]))
def test_lsm_matches_dict_oracle(seed, limit):
    twin(_lsm_oracle_case, seed, limit)


def test_lsm_compaction_preserves_newest():
    def case(P):
        dev = P.MemDevice()
        lsm = P.LSMTree(dev, "/db", memtable_limit_bytes=1 << 10, l0_limit=2,
                        fsync_writes=False)
        for round_ in range(5):
            for k in range(50):
                lsm.put(k, f"r{round_}k{k}".encode())
        lsm.flush()
        assert lsm.get(17) == b"r4k17"
        assert lsm.table_count() > 0
        return [lsm.get(k) for k in range(50)], lsm.table_count()

    twin(case)


def test_lsm_reopen_from_manifest():
    def case(P):
        dev = P.MemDevice()
        lsm = P.LSMTree(dev, "/db", memtable_limit_bytes=1 << 10, fsync_writes=False)
        for k in range(200):
            lsm.put(k, bytes([k % 251]) * 8)
        lsm.flush()
        lsm2 = P.LSMTree.open_existing(dev, "/db")
        got = [lsm2.get(k) for k in (0, 57, 199)]
        assert got == [bytes([k % 251]) * 8 for k in (0, 57, 199)]
        return got, bytes(dev._files["/db/MANIFEST.json"])

    twin(case)


def test_lsm_get_foreactor_equivalence():
    def case(P):
        rng = np.random.default_rng(2)
        dev = P.MemDevice()
        lsm = P.LSMTree(dev, "/db", memtable_limit_bytes=1 << 12, l0_limit=50,
                        fsync_writes=False)
        ref = {}
        for k in rng.permutation(500):
            v = f"val{k}".encode()
            lsm.put(int(k), v)
            ref[int(k)] = v
        lsm.flush()
        fa = P.Foreactor(device=dev, backend="io_uring", depth=16)
        P.plugins.register_all(fa)
        get = fa.wrap("lsm_get", P.plugins.capture_lsm_get)(lambda l, k: l.get(k))
        keys = [int(k) for k in rng.choice(500, 60)]
        got = [get(lsm, k) for k in keys]
        assert got == [ref[k] for k in keys]
        assert get(lsm, 10**7) is None
        fa.shutdown()
        return got

    twin(case)


# -- file utilities -----------------------------------------------------------------
def test_du_cp_equivalence():
    def case(P):
        dev = P.MemDevice()
        for i in range(12):
            fd = dev.open(f"/dir/f{i}", "w")
            dev.pwrite(fd, b"x" * (i * 100 + 1), 0)
            dev.close(fd)
        fa = P.Foreactor(device=dev, backend="io_uring", depth=8)
        P.plugins.register_all(fa)
        du = fa.wrap("du", P.plugins.capture_du)(P.du_dir)
        total = du(dev, "/dir")
        assert total == P.du_dir(dev, "/dir")
        src = bytes(np.random.default_rng(0).integers(0, 256, 300000, dtype=np.uint8))
        fd = dev.open("/src", "w")
        dev.pwrite(fd, src, 0)
        dev.close(fd)
        cp = fa.wrap("cp", P.plugins.capture_cp)(P.cp_file)
        cp(dev, "/src", "/dst", 32 * 1024)
        fd = dev.open("/dst", "r")
        out = dev.pread(fd, len(src), 0)
        assert out == src
        fa.shutdown()
        return total, out

    twin(case)


# -- test_plan.py's cases over the plugin graphs ------------------------------
PLUGIN_GRAPHS = ("du", "cp", "bptree_scan", "bptree_load", "lsm_get")
WALK_CTXS = {
    "du": {"root": "/d", "entries": ["x", "y"]},
    "cp": {"src": "/s", "dst": "/d", "buf_size": 4096, "size": 8192, "sfd": 3, "dfd": 4},
    "bptree_scan": {"fd": 3, "page_size": 64, "first_leaf": 0, "last_leaf": 1},
    "bptree_load": {"nleaves": 2},
    "lsm_get": {"cands": [1, 2], "key": 1},
}


def _graph(P, name):
    return getattr(P.plugins, f"build_{name}_graph")()


def _object_walk(P, graph, ctx, max_steps=200):
    out = []
    node, epochs, weak = graph.start.dst, graph.initial_epochs(), graph.start.weak
    steps = 0
    while steps < max_steps:
        while isinstance(node, P.BranchNode):
            idx = node.choose(ctx, epochs)
            if idx is None:
                return out, "stall"
            e = node.children[idx]
            if e.loop_id is not None:
                lst = list(epochs)
                lst[e.loop_id] += 1
                epochs = tuple(lst)
            weak = weak or e.weak
            node = e.dst
        if node is None:
            return out, "end"
        assert isinstance(node, P.SyscallNode)
        out.append((node.name, node.sc, epochs, weak))
        e = node.out
        if e.loop_id is not None:
            lst = list(epochs)
            lst[e.loop_id] += 1
            epochs = tuple(lst)
        weak = e.weak
        node = e.dst
        steps += 1
    return out, "limit"


def _plan_walk(P, plan, ctx, max_steps=200):
    out = []
    nid, epochs, weak = plan.start_dst, plan.initial_epochs(), plan.start_weak
    steps = 0
    while steps < max_steps:
        res = plan.resolve_branches(nid, epochs, ctx, weak)
        if res is None:
            return out, "stall"
        nid, epochs, weak = res
        if nid == P.END:
            return out, "end"
        assert plan.kind[nid] == P.KIND_SYSCALL
        out.append((plan.names[nid], plan.sc[nid], epochs, weak))
        nid, epochs, weak = plan.follow_out(nid, epochs)
        steps += 1
    return out, "limit"


@pytest.mark.parametrize("name", PLUGIN_GRAPHS)
def test_compile_twice_returns_identical_plan(name):
    def case(P):
        g = _graph(P, name)
        p1, p2 = P.compile_plan(g), P.compile_plan(g)
        assert p1 is p2
        assert p1.structure() == p2.structure()
        return plain(p1.structure())

    twin(case)


@pytest.mark.parametrize("name", PLUGIN_GRAPHS)
def test_plan_walk_matches_object_walk(name):
    def case(P):
        g = _graph(P, name)
        ref = _object_walk(P, g, dict(WALK_CTXS[name]))
        got = _plan_walk(P, P.compile_plan(g), dict(WALK_CTXS[name]))
        assert got == ref
        return plain(got)

    twin(case)


@pytest.mark.parametrize("name", PLUGIN_GRAPHS)
def test_topological_ids_are_dense_and_complete(name):
    def case(P):
        g = _graph(P, name)
        p = P.compile_plan(g)
        assert sorted(p.id_of.values()) == list(range(p.num_nodes))
        assert set(p.id_of) == set(g.syscall_nodes) | set(g.branch_nodes)
        for nid in range(p.num_nodes):
            if p.kind[nid] == P.KIND_BRANCH:
                assert p.choose[nid] is not None
            else:
                assert p.compute[nid] is not None
        return dict(p.id_of), list(p.kind)

    twin(case)


# -- test_futures.py's multi_get tests -----------------------------------------
CONFIGS = [
    ("sync", "flat", dict(backend="sync")),
    ("user_threads", "flat", dict(backend="user_threads", workers=4)),
    ("io_uring", "flat", dict(backend="io_uring", workers=4)),
    ("multi_queue", "sharded", dict(backend="multi_queue", workers=2)),
    ("shared", "flat", dict(backend="io_uring", workers=4, shared=True)),
]
QUERY = [0, 5, 7, 10, 30, 31, 64, 99, 119, 500, 17, 45]


def _make_device(P, kind):
    dev = P.ShardedDevice([P.MemDevice() for _ in range(3)]) if kind == "sharded" \
        else P.MemDevice()
    for i in range(6):
        fd = dev.open(f"/c/f{i}", "w")
        dev.pwrite(fd, bytes((i * 7 + j) % 251 for j in range(96)), 0)
        dev.close(fd)
    return dev


def _make_lsm(P, dev):
    lsm = P.LSMTree(dev, "/db", memtable_limit_bytes=1 << 10, l0_limit=10 ** 6,
                    fsync_writes=False)
    for k in range(120):
        lsm.put(k, f"v{k}".encode() * 3)
    lsm.flush()
    for k in range(0, 120, 3):
        lsm.put(k, f"w{k}".encode() * 2)
    lsm.flush()
    for k in range(0, 120, 10):
        lsm.put(k, f"mem{k}".encode())
    for k in range(5, 120, 20):
        lsm.delete(k)
    return lsm


def _ledger(stats):
    assert stats.pre_issued == (stats.served_async + stats.cancelled
                                + stats.wasted_completions), vars(stats)


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_multi_get_matches_sequential_gets(cfg):
    _name, kind, kwargs = cfg

    def case(P):
        dev = _make_device(P, kind)
        lsm = _make_lsm(P, dev)
        oracle = [lsm.get(k) for k in QUERY]
        fa = P.Foreactor(device=dev, depth=16, **kwargs)
        P.plugins.register_all(fa)
        mget = fa.wrap("lsm_multiget", P.plugins.capture_lsm_multiget)(
            lambda l, ks: l.multi_get(ks))
        got = mget(lsm, QUERY)
        assert got == oracle
        assert lsm.multi_get(QUERY) == oracle
        _ledger(fa.total_stats)
        extents = P.plugins.capture_lsm_multiget(lsm, QUERY)["extents"]
        fa.shutdown()
        return got, [(length, off) for _fd, length, off in extents]

    twin(case)


class _EIODevice:
    """Delegating device wrapper: pread at a poisoned offset raises EIO."""

    def __init__(self, inner):
        self.inner = inner
        self.eio_offsets = set()

    def pread(self, fd, size, off):
        if off in self.eio_offsets:
            raise OSError(errno.EIO, f"injected EIO at offset {off}")
        return self.inner.pread(fd, size, off)

    def pread_into(self, fd, buf, off):
        if off in self.eio_offsets:
            raise OSError(errno.EIO, f"injected EIO at offset {off}")
        return self.inner.pread_into(fd, buf, off)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_multi_get_eio_on_one_key_spares_the_rest():
    def case(P):
        dev = _EIODevice(P.MemDevice())
        lsm = P.LSMTree(dev, "/db", memtable_limit_bytes=1 << 20, l0_limit=10 ** 6,
                        fsync_writes=False)
        for k in range(64):
            lsm.put(k, f"v{k:03d}".encode() * 600)
        lsm.flush()
        keys = list(range(0, 64, 4))
        offsets = [lsm.candidates(k)[0][1] for k in keys]
        victim_i = next(i for i, off in enumerate(offsets) if offsets.count(off) == 1)
        dev.eio_offsets = {offsets[victim_i]}
        fa = P.Foreactor(device=dev, backend="io_uring", workers=4, depth=16)
        P.plugins.register_all(fa)
        mget = fa.wrap("lsm_multiget", P.plugins.capture_lsm_multiget)(
            lambda l, ks: l.multi_get(ks))
        with pytest.raises(OSError) as exc:
            mget(lsm, keys)
        assert exc.value.errno == errno.EIO
        stats = fa.total_stats
        assert stats.served_async >= len(keys) - 1, vars(stats)
        _ledger(stats)
        fa.shutdown()
        return victim_i, offsets, str(exc.value)

    twin(case)


# -- test_system.py's end-to-end checks (wall-clock bounds unchanged) ---------
def _fast(P):
    return P.DeviceProfile(channels=16, base_latency=8e-4, metadata_latency=6e-4,
                           crossing_cost=3e-6)


def best_of(fn, repeats=3):
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def _du_inner(P):
    inner = P.MemDevice()
    for i in range(80):
        fd = inner.open(f"/d/f{i}", "w")
        inner.pwrite(fd, b"z" * (i + 1), 0)
        inner.close(fd)
    return inner


def test_speculation_speeds_up_stat_loop():
    """du with pre-issuing beats serial du by the reference's bound, with
    the reference's result."""
    reference = J.du_dir(_du_inner(J), "/d")
    dev = T.SimulatedDevice(_du_inner(T), _fast(T))
    fa = T.Foreactor(device=dev, backend="io_uring", depth=16)
    T.plugins.register_all(fa)
    wrapped = fa.wrap("du", T.plugins.capture_du)(T.du_dir)
    expect, t_sync = best_of(lambda: T.du_dir(dev, "/d"))
    got, t_fa = best_of(lambda: wrapped(dev, "/d"))
    assert got == expect == reference
    assert t_fa < t_sync * 0.55, (t_fa, t_sync)
    fa.shutdown()


def _lsm_inner(P):
    rng = np.random.default_rng(0)
    inner = P.MemDevice()
    lsm = P.LSMTree(inner, "/db", memtable_limit_bytes=1 << 13, l0_limit=100,
                    fsync_writes=False)
    ref = {}
    for k in rng.permutation(1500):
        v = f"{k:08d}".encode() * 4
        lsm.put(int(k), v)
        ref[int(k)] = v
    lsm.flush()
    assert lsm.table_count() >= 4
    return inner, ref, [int(k) for k in rng.choice(1500, 40)]


def test_speculation_speeds_up_lsm_get():
    """Get over a multi-table chain is faster with speculation (the
    reference's bound), with the reference's answers."""
    j_inner, j_ref, j_keys = _lsm_inner(J)
    j_lsm = J.LSMTree.open_existing(j_inner, "/db")
    inner, ref, keys = _lsm_inner(T)
    assert keys == j_keys and ref == j_ref
    assert sorted(inner._files) == sorted(j_inner._files)
    dev = T.SimulatedDevice(inner, _fast(T))
    lsm_sim = T.LSMTree.open_existing(dev, "/db")
    fa = T.Foreactor(device=dev, backend="io_uring", depth=16)
    T.plugins.register_all(fa)
    get = fa.wrap("lsm_get", T.plugins.capture_lsm_get)(lambda l, k: l.get(k))

    def run_sync():
        for k in keys:
            assert lsm_sim.get(k) == ref[k] == j_lsm.get(k)

    def run_fa():
        for k in keys:
            assert get(lsm_sim, k) == ref[k]

    _, t_sync = best_of(run_sync, repeats=2)
    _, t_fa = best_of(run_fa, repeats=2)
    assert t_fa < t_sync, (t_fa, t_sync)
    fa.shutdown()


def test_backend_swap_preserves_semantics():
    def case(P):
        inner = P.MemDevice()
        for i in range(30):
            fd = inner.open(f"/d/f{i}", "w")
            inner.pwrite(fd, b"y" * (i + 1), 0)
            inner.close(fd)
        results = {}
        for backend in ("io_uring", "user_threads", "sync"):
            dev = P.SimulatedDevice(inner, _fast(P))
            fa = P.Foreactor(device=dev, backend=backend, depth=8)
            P.plugins.register_all(fa)
            results[backend] = fa.wrap("du", P.plugins.capture_du)(P.du_dir)(dev, "/d")
            fa.shutdown()
        assert len(set(results.values())) == 1
        return results

    twin(case)


# -- on-disk parity ------------------------------------------------------------
def _seeded_records(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(np.arange(20 * n, dtype=np.uint64), n, replace=False))
    return keys, rng.integers(0, 2**63, n).astype(np.uint64)


def _build_bptree(P, path, keys, vals):
    t = P.BPTree(P.OSDevice(), str(path), degree=37)
    if P is J:
        # the reference reads its internal pages back through the load's
        # write-only fd, which a real file system refuses once the file is
        # written (the port reopens the file for reading)
        with pytest.raises(OSError) as e:
            t.bulk_load(keys, vals)
        assert e.value.errno == errno.EBADF
    else:
        t.bulk_load(keys, vals)
    t.close()


def _build_lsm(P, root, seed):
    """Puts, overwrites and deletes through flushes and compactions."""
    rng = np.random.default_rng(seed)
    lsm = P.LSMTree(P.OSDevice(), str(root), memtable_limit_bytes=1 << 12, l0_limit=3)
    oracle = {}
    for i in range(3000):
        k = int(rng.integers(0, 800))
        if rng.random() < 0.08:
            lsm.delete(k)
            oracle[k] = None
        else:
            v = rng.bytes(int(rng.integers(1, 60)))
            lsm.put(k, v)
            oracle[k] = v
    lsm.flush()
    lsm.close()
    return oracle


def _files(root):
    return {name: (root / name).read_bytes() for name in sorted(os.listdir(root))}


def test_bptree_bulk_load_on_a_real_file_system_reads_back(tmp_path):
    """The port's repair: after ``bulk_load`` through ``OSDevice`` the tree
    answers from the file it wrote (the load's fd is write-only there)."""
    keys, vals = _seeded_records(2000, seed=1)
    dev = T.OSDevice()
    t = T.BPTree(dev, str(tmp_path / "t.db"), degree=64)
    t.bulk_load(keys, vals)
    oracle = dict(zip(keys.tolist(), vals.tolist()))
    assert t.scan(0, 2**63) == sorted(oracle.items())
    assert all(t.search(k) == oracle[k] for k in keys[::50].tolist())
    t.close()
    with pytest.raises(OSError) as e:
        J.BPTree(J.OSDevice(), str(tmp_path / "j.db"), degree=64).bulk_load(keys, vals)
    assert e.value.errno == errno.EBADF


def test_bptree_files_are_byte_identical(tmp_path):
    keys, vals = _seeded_records(5000, seed=3)
    _build_bptree(J, tmp_path / "j.db", keys, vals)
    _build_bptree(T, tmp_path / "t.db", keys, vals)
    j_bytes = (tmp_path / "j.db").read_bytes()
    assert (tmp_path / "t.db").read_bytes() == j_bytes
    assert len(j_bytes) > 100 * 8192


def test_lsm_files_are_byte_identical(tmp_path):
    # the manifest names its tables by path: both packages build under one root
    root = tmp_path / "db"
    j_oracle = _build_lsm(J, root, seed=5)
    j_files = _files(root)
    for p in root.iterdir():
        p.unlink()
    root.rmdir()
    t_oracle = _build_lsm(T, root, seed=5)
    assert t_oracle == j_oracle
    assert _files(root) == j_files
    assert len(j_files) > 3


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)], ids=["jax-to-torch", "torch-to-jax"])
def test_stores_written_by_one_package_open_in_the_other(tmp_path, writer, reader):
    keys, vals = _seeded_records(3000, seed=11)
    _build_bptree(writer, tmp_path / "t.db", keys, vals)
    t = reader.BPTree(reader.OSDevice(), str(tmp_path / "t.db")).open()
    oracle = dict(zip(keys.tolist(), vals.tolist()))
    assert t.scan(0, 2**63) == sorted(oracle.items())
    for k in keys[::97].tolist():
        assert t.search(k) == oracle[k] == t.search_cold(k)
    assert t.search(int(keys[-1]) + 1) is None
    t.close()

    oracle = _build_lsm(writer, tmp_path / "db", seed=13)
    lsm = reader.LSMTree.open_existing(reader.OSDevice(), str(tmp_path / "db"))
    assert [lsm.get(k) for k in sorted(oracle)] == [oracle[k] for k in sorted(oracle)]
    assert lsm.multi_get(sorted(oracle)) == [oracle[k] for k in sorted(oracle)]
    assert lsm.get(10**6) is None
    lsm.close()
