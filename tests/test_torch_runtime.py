"""The port's native host runtime (``lbfgs_ffnn_torch/runtime/runtime.cpp``,
built here with g++) against the JAX package's default, native, path on the
CPU:

* the default ``BatchStreamer`` bitwise equal to JAX's default (native)
  ``BatchStreamer`` over three epochs and the first batch of a fourth:
  batches, counts and epoch labels, for n in {20, 45, 257}, b in {1, 8, n},
  seeds {0, 5, 2**63 + 7}, ``drop_last`` both ways, depth 1 and 4;
* a uint8 x streams the rows of the f32 stream's permutation;
  ``force_fallback=True`` is JAX's numpy stream;
* ``sgd_streaming`` on both packages' default streams in f32 (each
  package's own f32 arithmetic), with and without ``full_eval_fn``: each
  within rtol 1e-6 of the port's f64 solve on the same batches, so within
  2e-6 of each other, and x to rtol 1e-6;
* the IDX readers, ``write_idx_u8`` and the CSV writer byte for byte equal to
  JAX's native output, and to the plain numpy versions (images within one
  float32 ulp: the plain reader divides by 255), with JAX's errors on bad
  files;
* a failed build raises with the compiler's stderr, and the streamer does
  not fall back to the numpy stream; the native producer's failure; several
  consumers on one native streamer (a stress test of the slot protocol).
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import ctypes
import importlib
import re
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.data import idx as jidx
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.recorder import History as JHistory
from lbfgs_ffnn_tpu.recorder import write_history_csv as j_write
from lbfgs_ffnn_tpu.runtime.streamer import BatchStreamer as JStreamer
from lbfgs_ffnn_torch import _build
from lbfgs_ffnn_torch.data import idx as tidx
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.recorder import History, write_history_csv, write_history_csv_plain
from lbfgs_ffnn_torch.runtime import BatchStreamer, get_lib, native

jsgd = importlib.import_module("lbfgs_ffnn_tpu.solvers.sgd")
tsgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")


def _xy(n, seed=0, xdim=5, ydim=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, xdim)).astype(np.float32),
            np.eye(ydim, dtype=np.float32)[rng.integers(0, ydim, n)])


def _same_stream(j, t, b, epochs=3):
    """Pull both streams until the first batch of epoch ``epochs``; every
    batch bitwise equal. Returns the count of short batches."""
    short = 0
    while True:
        jx, jy, jc, je = j.next()
        tx, ty, tc, te = t.next()
        assert (tc, te) == (jc, je)
        assert tx.shape == (b, jx.shape[1]) and ty.shape == (b, jy.shape[1])
        assert np.array_equal(tx.numpy(), jx) and np.array_equal(ty.numpy(), jy)
        if tc < b:
            short += 1
            assert not tx[tc:].any() and not ty[tc:].any()
        if te == epochs:
            return short


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("seed", [0, 5, 2**63 + 7])
@pytest.mark.parametrize("b", [1, 8, "n"])
@pytest.mark.parametrize("n", [20, 45, 257])
def test_default_stream_is_jaxs_native_stream(n, b, seed, drop_last, depth):
    b = n if b == "n" else b
    x, y = _xy(n, seed=n)
    j = JStreamer(x, y, b, seed=seed, drop_last=drop_last)
    assert j.native  # JAX's native stream, not its fallback
    with j, BatchStreamer(x, y, b, seed=seed, depth=depth, drop_last=drop_last) as t:
        assert t.native
        short = _same_stream(j, t, b)
    assert short == (0 if drop_last or n % b == 0 else 3)


@pytest.mark.parametrize("seed", [0, 5, 2**63 + 7])
def test_uint8_x_streams_the_f32_permutation(seed):
    n, b = 45, 8
    xf, y = _xy(n, seed=1, xdim=7)
    xq = np.round(np.abs(xf) * 60.0).clip(0, 255).astype(np.uint8)
    j = JStreamer(xq, y, b, seed=seed)  # JAX reads x as float32
    assert j.native
    with j, BatchStreamer(xq, y, b, seed=seed) as t:
        while True:
            jx, jy, jc, je = j.next()
            tx, ty, tc, te = t.next()
            assert tx.dtype == torch.uint8 and (tc, te) == (jc, je)
            assert np.array_equal(tx.numpy().astype(np.float32), jx)
            assert np.array_equal(ty.numpy(), jy)
            if te == 3:
                break


@pytest.mark.parametrize("n,b,seed", [(20, 8, 5), (45, 8, 0), (257, 32, 2**63 + 7)])
def test_fallback_stream_is_jaxs_fallback(n, b, seed):
    x, y = _xy(n, seed=n)
    with (JStreamer(x, y, b, seed=seed, force_fallback=True) as j,
          BatchStreamer(x, y, b, seed=seed, force_fallback=True) as t):
        assert not j.native and not t.native
        _same_stream(j, t, b)


def test_default_stream_differs_from_the_fallback():
    """n = 20, b = 8, seed 5: the native stream's first batch (JAX's
    default) and the numpy stream's (JAX's fallback) differ."""
    x = np.arange(20, dtype=np.float32)[:, None]
    with BatchStreamer(x, x, 8, seed=5) as t, BatchStreamer(x, x, 8, seed=5,
                                                            force_fallback=True) as f:
        assert t.next()[0][:, 0].tolist() == [10, 2, 5, 7, 12, 0, 19, 4]
        assert f.next()[0][:, 0].tolist() == [9, 18, 3, 7, 1, 16, 19, 13]


DIMS, ACTS = [6, 5, 3], ["relu", "linear"]
N, B = 45, 8


@pytest.mark.parametrize("full_eval", [False, True])
def test_sgd_streaming_on_default_streams_matches_jax(full_eval):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, DIMS[0])).astype(np.float32)
    y = np.eye(DIMS[-1], dtype=np.float32)[rng.integers(0, DIMS[-1], N)]
    w0 = (rng.normal(size=tmlp.mlp_spec(DIMS, ACTS).n_params) * 0.4).astype(np.float32)
    jp = jmlp.mlp_batch_problem(jmlp.mlp_spec(DIMS, ACTS))
    tp = tmlp.mlp_batch_problem(tmlp.mlp_spec(DIMS, ACTS))
    kw = dict(epochs=3, batch_size=B, step_size=0.1, momentum=0.9, lr_decay=0.5,
              lr_decay_step=2)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    j_eval = t_eval = None
    if full_eval:
        def j_eval(w):
            return jp.fun(w, jx, jy), jnp.linalg.norm(jp.grad(w, jx, jy))

        def t_eval(w):  # in w's dtype
            xw, yw = tx.to(w.dtype), ty.to(w.dtype)
            return tp.fun(w, xw, yw), torch.linalg.norm(tp.grad(w, xw, yw))

    with JStreamer(x, y, B, seed=5) as js:
        assert js.native
        rj = jsgd.sgd_streaming(jp, jnp.asarray(w0), js, jsgd.SGDOptions(**kw),
                                full_eval_fn=j_eval)
    with BatchStreamer(x, y, B, seed=5) as st:
        assert st.native
        rt = tsgd.sgd_streaming(tp, torch.tensor(w0), st, tsgd.SGDOptions(**kw),
                                full_eval_fn=t_eval)
    # the same batches in f64: each package's f32 solve lies within 1e-6 of
    # it, on either side, so the two lie within 2e-6 of each other (their
    # final gradient norms without full_eval_fn are 1.01e-6 apart)
    with BatchStreamer(x, y, B, seed=5) as st:
        r64 = tsgd.sgd_streaming(tp, torch.tensor(w0, dtype=torch.float64), _F64(st),
                                 tsgd.SGDOptions(**kw), full_eval_fn=t_eval)
    assert rt.n_iters == int(rj.n_iters) == r64.n_iters == 3 and not bool(rt.converged)
    for name in ("loss_history", "gnorm_history", "final_loss", "final_gnorm"):
        want = np.asarray(getattr(r64, name))
        got = {"port": np.asarray(getattr(rt, name)), "jax": np.asarray(getattr(rj, name))}
        for who, v in got.items():
            np.testing.assert_allclose(v, want, rtol=1e-6, err_msg=f"{who} {name}")
        np.testing.assert_allclose(got["port"], got["jax"], rtol=2e-6, err_msg=name)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rt.x.numpy(), r64.x.numpy(), rtol=1e-6, atol=1e-6)


class _F64:
    """A streamer's batches in f64."""

    def __init__(self, st):
        self.st, self.batch_size = st, st.batch_size

    def next(self):
        xb, yb, count, epoch = self.st.next()
        return xb.double(), yb.double(), count, epoch


# ---------------------------------------------------------------------------
# IDX and CSV through the library
# ---------------------------------------------------------------------------


@pytest.fixture
def idx_files(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(37, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=37, dtype=np.uint8)
    tidx.write_idx_u8(tmp_path / "images.idx3-ubyte", images)
    tidx.write_idx_u8(tmp_path / "labels.idx1-ubyte", labels)
    return tmp_path, images, labels


@pytest.mark.parametrize("max_items", [0, 11, 100])
def test_idx_readers_equal_jax_native(idx_files, max_items):
    root, images, labels = idx_files
    n = min(max_items, 37) if max_items else 37
    im, lb = root / "images.idx3-ubyte", root / "labels.idx1-ubyte"
    x_t = tidx.read_idx_images(im, max_items)
    assert x_t.dtype == np.float32 and x_t.shape == (n, 784)
    np.testing.assert_array_equal(x_t, jidx.read_idx_images(im, max_items))
    np.testing.assert_array_equal(x_t, images[:n].reshape(n, -1) * np.float32(1 / 255))
    np.testing.assert_allclose(x_t, tidx.read_idx_images_plain(im, max_items), rtol=1.2e-7,
                               atol=0)
    u8 = tidx.read_idx_labels_u8(lb, max_items)
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, jidx.read_idx_labels_u8(lb, max_items))
    np.testing.assert_array_equal(u8, tidx.read_idx_labels_u8_plain(lb, max_items))
    for classes in (10, 4):  # a label >= num_classes: a zero row, as JAX's native loader
        oh = tidx.read_idx_labels_onehot(lb, max_items, classes)
        np.testing.assert_array_equal(oh, jidx.read_idx_labels_onehot(lb, max_items, classes))
    np.testing.assert_array_equal(tidx.read_idx_labels_onehot(lb, max_items),
                                  tidx.read_idx_labels_onehot_plain(lb, max_items))


@pytest.mark.parametrize("shape", [(7,), (2, 3), (2, 3, 5), (1, 2, 3, 4)])
def test_write_idx_u8_equals_jax_native(tmp_path, shape):
    data = np.arange(int(np.prod(shape)), dtype=np.uint8).reshape(shape)
    tidx.write_idx_u8(tmp_path / "t.idx", data)
    jidx.write_idx_u8(tmp_path / "j.idx", data)
    tidx.write_idx_u8_plain(tmp_path / "p.idx", data)
    ref = (tmp_path / "j.idx").read_bytes()
    assert (tmp_path / "t.idx").read_bytes() == ref == (tmp_path / "p.idx").read_bytes()


def _raised(fn, *args):
    with pytest.raises(OSError) as info:
        fn(*args)
    return str(info.value)


@pytest.mark.parametrize("case", ["missing", "not_idx", "bad_dtype", "truncated", "images_as_labels"])
def test_idx_errors_are_jaxs(tmp_path, idx_files, case):
    root, _, _ = idx_files
    path = tmp_path / case
    if case == "not_idx":
        path.write_bytes(b"\x89PNG....")
    elif case == "bad_dtype":
        path.write_bytes(bytes([0, 0, 0x0D, 1]) + (3).to_bytes(4, "big") + bytes(12))
    elif case == "truncated":
        path.write_bytes((root / "images.idx3-ubyte").read_bytes()[:2000])
    elif case == "images_as_labels":
        path = root / "images.idx3-ubyte"
    for name in ("read_idx_images", "read_idx_labels_onehot"):
        if case == "images_as_labels" and name == "read_idx_images":
            continue
        want = _raised(getattr(jidx, name), path)
        assert _raised(getattr(tidx, name), path) == want
        assert re.fullmatch(r"idx_\w+\(.+\) failed: -[123]", want)


def test_write_idx_u8_error_is_jaxs(tmp_path):
    path = tmp_path / "no_such_dir" / "x.idx"
    data = np.zeros(3, np.uint8)
    assert _raised(tidx.write_idx_u8, path, data) == _raised(jidx.write_idx_u8, path, data)


@pytest.mark.parametrize("log_interval", [1, 3])
@pytest.mark.parametrize("special", [False, True])
def test_history_csv_equals_jax_native(tmp_path, log_interval, special):
    rng = np.random.default_rng(3)
    loss, gnorm = rng.random(7) * 10.0 ** rng.integers(-20, 20, 7), rng.random(7)
    tms = np.linspace(0.5, 3.5, 7)
    if special:  # C's printf words for these, as JAX's native writer's
        loss[[0, 3]], gnorm[[3, 6]] = np.nan, [np.inf, -np.inf]
    h, jh = History(loss, gnorm, tms), JHistory(loss, gnorm, tms)
    write_history_csv(tmp_path / "t.csv", h, log_interval)
    j_write(str(tmp_path / "j.csv"), jh, log_interval)
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    if not special:
        write_history_csv_plain(tmp_path / "p.csv", h, log_interval)
        assert text == (tmp_path / "p.csv").read_text()
    extra = {"TrainAcc": rng.random(7) * 100}
    write_history_csv(tmp_path / "te.csv", h, log_interval, extra)
    j_write(str(tmp_path / "je.csv"), jh, log_interval, extra)
    assert (tmp_path / "te.csv").read_text() == (tmp_path / "je.csv").read_text()


# ---------------------------------------------------------------------------
# Build failures, producer failures, concurrent consumers
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded runtime (both restored)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_failed_build_raises_and_does_not_fall_back(fresh_build, monkeypatch):
    cxx = fresh_build / "cxx"
    cxx.write_text("#!/bin/sh\necho 'runtime.cpp:1: error: compiler says no' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match=r"cxx failed \(3\)(.|\n)*compiler says no"):
        get_lib()
    x, y = _xy(20)
    with pytest.raises(RuntimeError, match="compiler says no"):
        BatchStreamer(x, y, 8)
    with pytest.raises(RuntimeError, match="compiler says no"):
        tidx.read_idx_images(fresh_build / "any")
    with BatchStreamer(x, y, 8, force_fallback=True) as st:  # asked for: the numpy stream
        assert not st.native and st.next()[2] == 8
    monkeypatch.setenv("CXX", str(fresh_build / "no_such_compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        get_lib()


def test_build_is_cached_by_source_compiler_and_flags(fresh_build):
    first = _build.build_host(native.SRC)
    assert first.compiled and first.path.parent == fresh_build / "build"
    again = _build.build_host(native.SRC)
    assert not again.compiled and again.path == first.path
    assert get_lib().idx_query is not None


def test_native_producer_failure_is_reported():
    lib = get_lib()
    x, y = _xy(20)
    bufs = [np.zeros((8, 5), np.float32), np.zeros((8, 3), np.float32)]
    slots = [(ctypes.c_void_p * 1)(b.ctypes.data) for b in bufs]
    # 2**61 rows: the producer's permutation cannot be allocated, so it throws
    h = lib.streamer_create(x.ctypes.data, y.ctypes.data, 2**61, 20, 12, 8, 0, 1, 0, *slots)
    assert h > 0
    out = [ctypes.c_int64() for _ in range(3)]
    assert lib.streamer_next(h, -1, *map(ctypes.byref, out)) == native.ERR_PRODUCER
    assert lib.streamer_destroy(h) == 0
    assert lib.streamer_destroy(h) == -4 and lib.streamer_next(h, -1, *map(ctypes.byref, out)) == -4
    with BatchStreamer(x, y, 8) as st:  # the class's report of it
        good, st._handle = st._handle, lib.streamer_create(
            x.ctypes.data, y.ctypes.data, 2**61, 20, 12, 8, 0, 1, 0, *slots)
        with pytest.raises(RuntimeError, match="producer failed"):
            st.next()
        lib.streamer_destroy(st._handle)
        st._handle, st._held = good, None


def test_native_streamer_checks_and_closes():
    x, y = _xy(45)
    with pytest.raises(ValueError):
        BatchStreamer(x, y[:-1], 8)
    with pytest.raises(ValueError):
        BatchStreamer(x, y, 8, depth=0)
    st = BatchStreamer(x, y, 100)  # the batch clamps to n
    assert st.native and st.batch_size == 45 and not st.pinned
    assert st.next()[2] == 45
    st.close()
    st.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        st.next()


def test_native_batch_stays_valid_until_next():
    """depth 1: the producer cannot refill the held slot before next()."""
    x, y = _xy(45)
    with BatchStreamer(x, y, 8, seed=3, depth=1) as st, JStreamer(x, y, 8, seed=3) as j:
        for _ in range(12):
            xb, _, _, _ = st.next()
            held = xb.clone()
            threading.Event().wait(0.002)  # the producer had time to overwrite it
            assert torch.equal(xb, held)
            assert np.array_equal(held.numpy(), j.next()[0])


def test_native_slot_protocol_under_concurrent_consumers():
    """More consumer threads than slots (and than cores, with a short switch
    interval), each holding its slot until its next pop: the batches popped
    are the single-consumer stream's first ones, none lost, none read twice,
    none overwritten while held. Destroying the streamer wakes the consumers
    still waiting."""
    lib = get_lib()
    n, b, depth, threads, total = 64, 4, 3, 12, 480  # 30 epochs
    x = np.arange(n, dtype=np.float32)[:, None].repeat(2, axis=1)
    y = np.arange(n, dtype=np.float32)[:, None]
    xs = [np.zeros((b, 2), np.float32) for _ in range(depth)]
    ys = [np.zeros((b, 1), np.float32) for _ in range(depth)]
    slots = [(ctypes.c_void_p * depth)(*(a.ctypes.data for a in bufs)) for bufs in (xs, ys)]
    h = lib.streamer_create(x.ctypes.data, y.ctypes.data, n, 8, 4, b, 11, depth, 0, *slots)
    got, errors, lock = [], [], threading.Lock()

    def consume():
        out, release = [ctypes.c_int64() for _ in range(3)], -1
        while True:
            with lock:
                if len(got) >= total:
                    return  # holding its last slot
            rc = lib.streamer_next(h, release, *map(ctypes.byref, out))
            if rc == -4:  # destroyed
                return
            slot, count, epoch = (v.value for v in out)
            ids = tuple(int(v) for v in ys[slot][:count, 0])
            threading.Event().wait(0.0002)  # hold it a while
            if rc != 0 or ids != tuple(int(v) for v in xs[slot][:count, 1]) or \
                    ids != tuple(int(v) for v in ys[slot][:count, 0]):
                errors.append((rc, slot, ids))
            with lock:
                got.append((epoch, ids))
            release = slot

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=consume) for _ in range(threads)]
        for w in workers:
            w.start()
        done = threading.Event()
        for _ in range(600):
            if len(got) >= total or done.wait(0.1):
                break
    finally:
        sys.setswitchinterval(switch)
        lib.streamer_destroy(h)  # wakes the consumers blocked on a full ring
        for w in workers:
            w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    assert not errors, errors[:5]
    assert len(got) >= total
    with JStreamer(y, y, b, seed=11) as j:
        assert j.native
        want = []
        for _ in range(len(got)):
            _, jy, jc, je = j.next()
            want.append((je, tuple(int(v) for v in jy[:jc, 0])))
    assert sorted(got) == sorted(want)
