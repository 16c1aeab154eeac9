"""Slice 7 of the port on the CPU: the segment-sum kernel's new design, and
the episode modes and runners, against the JAX package.

  * segment-sum (`csrc/segment_sum.cu`): the kernel's algorithm emulated
    in numpy step for step (a warp per group of 16 rows, out-of-range rows
    skipped before their weights are read, runs of equal ids summed in
    f32 in row order, one flush per run and nonzero 4-lane group into a
    buffer padded to 4 lanes), held to `jax.ops.segment_sum` within rows
    in the cell x 2^-24 x sum|w| (the count lane exact) on the memory
    write's rows, random, coherent and one-cell ids and K % 4 in {0, 1,
    3}, and to `scatter_sum_pallas(interpret=True)` as
    tests/test_torch_ops.py holds the plain version; the memory write
    through it (reading the padded buffer's [:, :K] view) against JAX's;
  * episode modes: `episodic` and `longterm` over 5-frame chunks, external
    GT memories (`semantic_gt`, `map_gt`), the pipelined and the batched
    runners, each against the JAX package's runner on the same weights
    (`convert/from_jax.py:load_jax_params`), at the tolerances of
    tests/test_torch_frame.py's `test_episode_chunk_vs_jax`: detection
    scores (rtol 1e-3, atol 1e-4), boxes rtol 1e-3 and atol 1e-2, memory
    rtol and atol 1e-3, observation counts exact;
  * `check_slice_config`'s protocols and memory types, and
    `engine/eval.py:external_memory_state`'s padding and errors.

The kernel itself is held against the plain version on the card in
tests/test_torch_kernels.py and by chip_smoke.py phase 3.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.engine.eval import (
    external_memory_state as jax_external_memory_state)
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector, FrameInputs as JaxFrames,
    make_batched_episode_runner as jax_batched_runner,
    make_episode_runner as jax_episode_runner,
    make_pipelined_episode_runner as jax_pipelined_runner)
from embodied_object_detection_tpu.ops import memory_ops as jmem
from embodied_object_detection_tpu.ops.pallas_scatter import scatter_sum_pallas
from embodied_object_detection_tpu.structures import (
    Detections as JaxDetections, MemoryState as JaxMemory)

from embodied_object_detection_tpu_torch import config as port_config
from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.engine.eval import (
    external_memory_state)
from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.models import detector as tdet
from embodied_object_detection_tpu_torch.ops import mask_paste as tmask
from embodied_object_detection_tpu_torch.ops import memory_ops as tmem
from embodied_object_detection_tpu_torch.ops import segment_sum as tseg
from embodied_object_detection_tpu_torch.structures import (
    Detections, MemoryState)

from test_torch_frame import (_blocky_proj, _check_detections, _jax_config,
                              _port_config)

T = torch.from_numpy
F32 = np.float32
ROWS = 16           # rows a warp (csrc/segment_sum.cu kRows)
SWEEP = 4 * 32      # columns a warp sweeps at once: 32 lanes x 4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------ segment-sum

def _emulated_segment_sum(w, idx, cells):
    """Kernel 1 step for step. Returns the [cells, K] view of the padded
    [cells, K'] buffer, the buffer, the number of float4 flushes and the
    rows whose weights were read."""
    s, k = w.shape
    padded = -(-k // 4) * 4
    out = np.zeros((cells, padded), F32)
    read = np.zeros(s, bool)
    flushes = 0

    def flush(cell, acc, c0):
        nonlocal flushes
        if cell < 0:
            return
        groups = acc.reshape(-1, 4)                      # lane g's float4
        owns = c0 + 4 * np.arange(32) < k
        nonzero = (groups != 0).any(1) & owns
        dst = out[cell].reshape(-1, 4)[c0 // 4:c0 // 4 + 32]
        dst[nonzero[:len(dst)]] += groups[:len(dst)][nonzero[:len(dst)]]
        flushes += int(nonzero.sum())

    for r0 in range(0, s, ROWS):
        ids = idx[r0:r0 + ROWS]
        live = np.flatnonzero((ids >= 0) & (ids < cells))    # the ballot
        for c0 in range(0, k, SWEEP):
            n = min(SWEEP, k - c0)
            acc = np.zeros(SWEEP, F32)
            run = -1
            for i in live:                     # in row order
                row = np.zeros(SWEEP, F32)
                row[:n] = w[r0 + i, c0:c0 + n]
                read[r0 + i] = True
                if ids[i] != run:
                    flush(run, acc, c0)
                    acc = np.zeros(SWEEP, F32)
                    run = ids[i]
                acc += row                     # f32, one add a lane
            flush(run, acc, c0)
    return out[:, :k], out, flushes, read


def _runs(rng, rows, cells, run):
    """Ids in runs of `run` rows on one cell; every other block of 40 runs
    repeats the cells of the block before it (the next image row of the
    same pixel blocks)."""
    n = -(-rows // run)
    ids = rng.randint(0, cells, n)
    ids[40:] = np.where(rng.rand(n - 40) < 0.5, ids[:-40], ids[40:])
    return np.repeat(ids, run)[:rows].astype(np.int32)


def _rows(case, lanes, seed, rows=2000, cells=256):
    """Mask-weight rows like the write's (1-3 covering masks of weight
    1/c, a count lane of 1), 1 in 8 an empty slot (id -1, NaN weights that
    must never be read) and some ids beyond the cells."""
    rng = np.random.RandomState(seed)
    w = np.zeros((rows, lanes), F32)
    cover = rng.randint(1, 4, rows)
    for r in range(rows):
        m = rng.choice(lanes - 1, cover[r], replace=False)
        w[r, m] = F32(1) / F32(cover[r])
    w[:, -1] = 1.0
    if case == "random":
        idx = rng.randint(0, cells, rows).astype(np.int32)
    elif case == "coherent":
        idx = _runs(rng, rows, cells, 4)
    else:                                      # one cell
        idx = np.full(rows, 5, np.int32)
    empty = rng.rand(rows) < 1 / 8
    idx[empty] = -1
    w[empty] = np.nan
    idx[rng.rand(rows) < 0.02] = cells + 7
    return w, idx, cells


def _frame_rows(seed=70):
    """The memory write's [H * J, N + 1] rows as JAX's exact write builds
    them (empty slots carry id -1 here, as the port's selection emits
    them), with pasted masks, the miniature's 64 x 96 and blocky ids."""
    rng = np.random.RandomState(seed)
    h, w, n, cells = 64, 96, 8, 64
    probs = rng.rand(n, 28, 28).astype(F32)
    x0, y0 = rng.uniform(-8, w - 16, n), rng.uniform(-8, h - 16, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(8, 60, n),
                      y0 + rng.uniform(8, 40, n)], 1).astype(F32)
    masks = _np(tmask.paste_masks(T(probs), T(boxes), h, w, 0.5,
                                  pixel_major=True))
    valid = rng.rand(n) > 0.2
    proj = _blocky_proj(rng, h, w, cells)
    seg, aug = tmem.write_select_plain(T(masks), T(valid), T(proj), 8)
    return masks, valid, proj, _np(seg), _np(aug), cells


def _held_to_jax(got, w, idx, cells):
    """Within rows in the cell x 2^-24 x sum|w| of jax.ops.segment_sum; the
    count lane exact."""
    keep = (idx >= 0) & (idx < cells)
    w = np.where(keep[:, None], w, 0).astype(F32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(idx),
                                          num_segments=cells))
    rows_in_cell = np.bincount(idx[keep], minlength=cells)
    abs_sum = np.asarray(jax.ops.segment_sum(
        jnp.abs(jnp.asarray(w)), jnp.asarray(idx), num_segments=cells))
    bound = rows_in_cell[:, None] * 2.0 ** -24 * abs_sum + 1e-7
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    assert np.array_equal(got[:, -1], rows_in_cell.astype(F32))


@pytest.mark.parametrize("case,lanes", [
    ("random", 101), ("coherent", 101), ("one_cell", 101),
    ("coherent", 100), ("random", 97), ("coherent", 7), ("random", 259)])
def test_emulated_segment_sum_vs_jax(case, lanes):
    """K % 4 = 1 (the frame's 101 and 97), 0 (100) and 3 (7 and 259, two
    sweeps); the emulation reads exactly the rows with an id in range."""
    w, idx, cells = _rows(case, lanes, seed=lanes)
    got, buf, flushes, read = _emulated_segment_sum(w, idx, cells)
    _held_to_jax(got, w, idx, cells)
    assert np.array_equal(read, (idx >= 0) & (idx < cells))
    assert buf.shape == (cells, -(-lanes // 4) * 4)
    assert not buf[:, lanes:].any()
    # a flush per run and nonzero 4-lane group, never more than one per
    # live row and group
    assert flushes <= read.sum() * -(-lanes // 4)


def test_emulated_segment_sum_flushes_runs_once():
    """Runs of equal ids flush once: coherent ids need fewer flushes than
    random ones, one cell fewest; with unit rows a group of ROWS live rows
    on one cell flushes each nonzero group once."""
    counts = {}
    for case in ("random", "coherent", "one_cell"):
        w, idx, cells = _rows(case, 101, seed=5)
        counts[case] = _emulated_segment_sum(w, idx, cells)[2]
    assert counts["one_cell"] < counts["coherent"] < counts["random"]
    w = np.ones((ROWS * 3, 9), F32)
    idx = np.full(ROWS * 3, 2, np.int32)
    got, _, flushes, _ = _emulated_segment_sum(w, idx, 4)
    assert flushes == 3 * 3                    # 3 warps x 3 groups
    assert (got[2] == ROWS * 3).all() and not got[[0, 1, 3]].any()


def test_emulated_segment_sum_on_the_frames_rows_vs_jax():
    masks, valid, proj, seg, aug, cells = _frame_rows()
    assert (seg < 0).any() and (seg >= 0).sum() > 100
    got, _, _, read = _emulated_segment_sum(aug, seg, cells)
    _held_to_jax(got, aug, seg, cells)
    assert np.array_equal(read, seg >= 0)


def test_emulated_segment_sum_vs_pallas_interpret():
    """As tests/test_torch_ops.py holds the plain version: the Pallas
    kernel rounds the weights to bf16 and sums in f32."""
    rng = np.random.RandomState(1)
    rows, lanes, cells = 700, 128, 256
    w = rng.rand(rows, lanes).astype(F32)
    w[rng.rand(rows, lanes) < 0.7] = 0.0
    idx = _runs(rng, rows, cells, 3)
    idx[::9] = -1
    want = np.asarray(scatter_sum_pallas(jnp.asarray(w), jnp.asarray(idx),
                                         cells, pixel_tile=512,
                                         interpret=True))
    rounded = np.array(jnp.asarray(w).astype(jnp.bfloat16).astype(
        jnp.float32))
    got_rounded = _emulated_segment_sum(rounded, idx, cells)[0]
    np.testing.assert_allclose(got_rounded, want, rtol=1e-5, atol=1e-5)
    got = _emulated_segment_sum(w, idx, cells)[0]
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-2)


@pytest.mark.parametrize("features", ["random", "identity"])
def test_memory_write_through_emulated_segment_sum_vs_jax(monkeypatch,
                                                         features):
    """The write reads the kernel's [:, :K] view of the padded buffer (row
    stride K') as it reads a dense result: JAX's exact write within 1e-5
    (sums in another order), and bit for bit with identity features and
    one pixel a cell."""
    masks, valid, proj, _, _, cells = _frame_rows(71)
    n = len(valid)
    if features == "identity":
        h, w = proj.shape
        proj = np.arange(h * w, dtype=np.int32).reshape(h, w)
        cells = h * w
        feats = np.eye(n, dtype=F32)
    else:
        feats = (np.random.RandomState(72).randn(n, 16) * 50).astype(F32)
    views = []

    def emulated(aug, seg, num_cells):
        view = T(_emulated_segment_sum(_np(aug), _np(seg), num_cells)[0])
        views.append(view)
        return view

    monkeypatch.setattr(tmem, "segment_sum", emulated)
    got = tmem.memory_write(T(feats), T(masks), T(valid), T(proj), cells,
                            subsample=8, exact_subsample=True,
                            pixel_major=True)
    want = jmem.memory_write(jnp.asarray(feats), jnp.asarray(masks),
                             jnp.asarray(valid), jnp.asarray(proj), cells,
                             subsample=8, exact_subsample=True,
                             pixel_major=True)
    (view,) = views
    assert view.stride() == (-(-(n + 1) // 4) * 4, 1)
    assert np.abs(np.asarray(want.features_update)).max() > 0
    if features == "identity":
        assert np.array_equal(_np(got.features_update),
                              np.asarray(want.features_update))
    else:
        np.testing.assert_allclose(_np(got.features_update),
                                   np.asarray(want.features_update),
                                   rtol=1e-5, atol=1e-5)
    assert np.array_equal(_np(got.obs_update), np.asarray(want.obs_update))


@pytest.mark.parametrize("lanes", [101, 100, 7])
def test_segment_sum_wrapper_launches_into_a_padded_buffer(monkeypatch,
                                                          lanes):
    """On the card the wrapper zero-fills [cells, K'] (K' = K rounded up
    to 4) and returns its [:, :K] view; the launch gets K and K'."""
    calls = []
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load",
                        lambda name: lambda *a: calls.append((name, a)) or 0)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)
    w = torch.ones((40, lanes))
    idx = torch.zeros(40, dtype=torch.int32)
    before = tseg.segment_sum.launches
    out = tseg.segment_sum(w, idx, 6)
    assert tseg.segment_sum.launches == before + 1
    ((name, args),) = calls
    padded = -(-lanes // 4) * 4
    assert name == "segment_sum"
    assert args[:2] == (w.data_ptr(), idx.data_ptr())
    assert args[3:7] == (40, lanes, padded, 6)
    assert len(args) == len(build.ENTRY_POINTS["segment_sum"][1])
    assert out.shape == (6, lanes) and out.stride() == (padded, 1)
    assert out.data_ptr() == args[2] and args[2] % 16 == 0
    assert not out.any()


def test_segment_sum_kernel_source():
    src = (build.CSRC / "segment_sum.cu").read_text()
    assert f"kRows = {ROWS};" in src
    for note in ("__ballot_sync", "atomicAdd(reinterpret_cast<float4*>",
                 "What bounds it on Hopper", "acc.x += v[u].x;",
                 "if (row[u] < 0) break;"):
        assert note in src
    # no per-element division: the only '/' in the code are comments and
    # the launch's grid arithmetic
    code = [line.split("//")[0] for line in src.splitlines()]
    divisions = [line for line in code if "/" in line]
    assert len(divisions) == 2 and all("+ kRows - 1) / kRows" in line or
                                       "+ kWarps - 1) / kWarps" in line
                                       for line in divisions)


# ------------------------------------------------------------ episode modes

@pytest.fixture(scope="module")
def fx():
    cfg = _jax_config()
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    model = JaxDetector(cfg)
    dummy = dict(
        image=jnp.zeros((h, w, 3)),
        zs_weight=jnp.zeros((cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)),
        mem_features=jnp.zeros((cells, d)), mem_obs=jnp.zeros((cells,)),
        proj_indices=jnp.zeros((h, w), jnp.int32),
        outlier_mask=jnp.zeros((h, w), bool))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), **dummy)
    state = load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.RandomState(17)
    images = rng.randint(0, 255, (6, h, w, 3)).astype(F32)
    projs = np.stack([_blocky_proj(rng, h, w, cells) for _ in range(6)])
    zs = rng.randn(cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)
    zs = zs.astype(F32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    return dict(cfg=cfg, params=params, state=state, images=images,
                projs=projs, zs=zs)


def _mode(fx, **memory):
    """The JAX config and model, and the port's, with memory settings."""
    cfg = fx["cfg"]
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory, **memory))
    port = tdet.build_detector(_port_config(cfg), seed=1, device="cpu")
    port.load_state_dict(fx["state"])
    return cfg, JaxDetector(cfg), port


def _frames(fx, resets, starts, t=None, valid=None):
    """The same chunk for both packages ([T, ...], or [B, T, ...] when the
    arrays carry a stream axis)."""
    cfg = fx["cfg"]
    resets, starts = np.array(resets), np.array(starts)
    shape = resets.shape
    images = fx["images"][:shape[-1]]
    projs = fx["projs"][:shape[-1]]
    if len(shape) == 2:               # streams: stream b starts at frame b
        images = np.stack([fx["images"][b:b + shape[1]]
                           for b in range(shape[0])])
        projs = np.stack([fx["projs"][b:b + shape[1]]
                          for b in range(shape[0])])
    frames = tdet.frame_inputs(images, projs, resets, cfg.memory.max_cells,
                               "cpu", frame_valid=valid,
                               episode_start=starts)
    jframes = JaxFrames(
        image=jnp.asarray(images), proj_indices=jnp.asarray(projs),
        outlier_mask=jnp.zeros(projs.shape, bool),
        obs_visibility=jnp.asarray(frames.obs_visibility.numpy()),
        memory_reset=jnp.asarray(resets), episode_start=jnp.asarray(starts),
        frame_valid=None if valid is None else jnp.asarray(valid))
    return frames, jframes


def _memory(fx, seed=None):
    cells, d = fx["cfg"].memory.max_cells, fx["cfg"].memory.memory_dim
    if seed is None:
        return MemoryState.zeros(cells, d, "cpu"), JaxMemory.zeros(cells, d)
    rng = np.random.RandomState(seed)
    f = (rng.randn(cells, d) * 5).astype(F32)
    o = rng.randint(0, 3, cells).astype(F32)
    return MemoryState(T(f), T(o)), JaxMemory(jnp.asarray(f), jnp.asarray(o))


def _check_episode(got, want, memory=True):
    """test_episode_chunk_vs_jax's tolerances, frame by frame."""
    assert np.array_equal(_np(got.any_detection),
                          np.asarray(want.any_detection))
    for t in range(got.detections.boxes.shape[0]):
        _check_detections(Detections(*[x[t] for x in got.detections]),
                          JaxDetections(*[x[t] for x in want.detections]),
                          (1e-3, 1e-4), 1e-2)
    if memory:
        for g, w in ((got.memory, want.memory),
                     (got.first_memory, want.first_memory)):
            np.testing.assert_allclose(_np(g.features),
                                       np.asarray(w.features), rtol=1e-3,
                                       atol=1e-3)
            assert np.array_equal(_np(g.obs_count), np.asarray(w.obs_count))


def _spy(monkeypatch, port):
    """Record, for each frame the port runs, the memory it read and the
    update it wrote."""
    log = []
    step = port.frame_step

    def spy(image, zs, mem_features, mem_obs, *args, **kwargs):
        out = step(image, zs, mem_features, mem_obs, *args, **kwargs)
        log.append((mem_features.clone(), mem_obs.clone(),
                    out.write.features_update, out.write.obs_update))
        return out

    monkeypatch.setattr(port, "frame_step", spy)
    return log


EPISODES = [
    # (test_type, resets, episode starts, frames that read another memory
    # than the live one)
    ("episodic", [True, False, False, True, False],
     [True, False, False, True, False], 0),
    # frames 1, 2 read frame 0's snapshot, frame 4 frame 3's
    ("longterm", [True, False, False, False, False],
     [True, False, False, True, False], 3),
    # a reset at frame 3 without an episode start zeroes the snapshot too:
    # frames 1 and 4 read a frozen memory
    ("longterm", [True, False, False, True, False],
     [True, False, True, False, False], 2),
]


@pytest.mark.parametrize("test_type,resets,starts,frozen", EPISODES)
def test_episode_modes_vs_jax(fx, monkeypatch, test_type, resets, starts,
                              frozen):
    """Both runners on one chunk; then what each of the port's frames read:
    the live memory (episodic), else the snapshot of the live memory at
    the last episode start, zeroed by a reset since."""
    cfg, jmodel, port = _mode(fx, test_type=test_type)
    frames, jframes = _frames(fx, resets, starts)
    mem, jmem0 = _memory(fx)
    log = _spy(monkeypatch, port)
    got = tdet.make_episode_runner(port, port.cfg)(frames, T(fx["zs"]), mem)
    want = jax.jit(jax_episode_runner(jmodel, cfg))(
        fx["params"], jframes, jnp.asarray(fx["zs"]), jmem0)
    _check_episode(got, want)
    assert got.any_detection[:3].any(), "no write: weak fixture"
    live = snap = (mem.features, mem.obs_count)
    stale = 0
    for t, (read_f, read_o, upd_f, upd_o) in enumerate(log):
        if resets[t]:
            live = snap = tuple(torch.zeros_like(x) for x in live)
        if test_type == "episodic" or starts[t]:
            snap = live
        assert torch.equal(read_f, snap[0]) and torch.equal(read_o, snap[1])
        stale += not torch.equal(read_f, live[0])
        live = (live[0] + upd_f, live[1] + upd_o)
    assert torch.equal(live[0], got.memory.features)
    assert stale == frozen


def test_longterm_needs_episode_starts(fx):
    _, _, port = _mode(fx, test_type="longterm")
    frames, _ = _frames(fx, [True, False], [True, False])
    run = tdet.make_episode_runner(port, port.cfg)
    with pytest.raises(ValueError, match="episode_start"):
        run(frames._replace(episode_start=None), T(fx["zs"]),
            _memory(fx)[0])
    # the live-memory protocols take chunks without them
    _, _, default = _mode(fx)
    out = tdet.make_episode_runner(default, default.cfg)(
        frames._replace(episode_start=None), T(fx["zs"]), _memory(fx)[0])
    assert out.detections.boxes.shape[0] == 2


# ------------------------------------------------------------ external

def _table(fx, rows, seed):
    rng = np.random.RandomState(seed)
    table = (rng.randn(rows, fx["cfg"].memory.memory_dim) * 3).astype(F32)
    table[0] = 0.0                       # the class table's zero row 0
    obs = rng.randint(0, 4, rows).astype(F32)
    return table, obs


@pytest.mark.parametrize("memory_type", ["semantic_gt", "map_gt"])
def test_external_memory_vs_jax(fx, monkeypatch, memory_type):
    """The table is read, never reset or written: it comes back bit for bit
    as the memory and the first memory, each frame reads it, no write runs
    (no write-NMS rows, paste, selection or segment-sum), and the
    detections match JAX's runner on the same table."""
    cfg, jmodel, port = _mode(fx, memory_type=memory_type)
    table, obs = _table(fx, 40, seed=len(memory_type))
    chunk = types.SimpleNamespace(
        memory_features=table,
        observations=None if memory_type == "semantic_gt" else obs)
    mem = external_memory_state(chunk, port.cfg, device="cpu")
    jmem0 = jax_external_memory_state(chunk, cfg)
    assert np.array_equal(_np(mem.features), np.asarray(jmem0.features))
    assert np.array_equal(_np(mem.obs_count), np.asarray(jmem0.obs_count))
    before = [x.clone() for x in mem]
    writes = []
    for name in ("memory_write", "paste_masks_observed", "paste_masks"):
        fn = getattr(tdet, name)
        monkeypatch.setattr(tdet, name, lambda *a, fn=fn, **k:
                            writes.append(fn) or fn(*a, **k))
    counters = {f: f.launches for f in (tseg.segment_sum, tmem.write_select)}
    log = _spy(monkeypatch, port)
    resets = [True, False, True, False]
    frames, jframes = _frames(fx, resets, resets)
    got = tdet.make_episode_runner(port, port.cfg)(frames, T(fx["zs"]), mem)
    want = jax.jit(jax_episode_runner(jmodel, cfg))(
        fx["params"], jframes, jnp.asarray(fx["zs"]), jmem0)
    _check_episode(got, want, memory=False)
    for x, y in zip(before, mem):
        assert torch.equal(x, y)
    for state in (got.memory, got.first_memory):
        assert torch.equal(state.features, before[0])
        assert torch.equal(state.obs_count, before[1])
    assert all(torch.equal(f, before[0]) for f, *_ in log) and len(log) == 4
    assert not writes and not got.any_detection.any()
    assert all(f.launches == n for f, n in counters.items())
    assert int(got.detections.valid.sum()) > 0
    # the table feeds the frame: another table gives other detections
    other = tdet.make_episode_runner(port, port.cfg)(
        frames, T(fx["zs"]), MemoryState(before[0] * 0, before[1]))
    assert not torch.equal(other.detections.scores, got.detections.scores)


# ------------------------------------------------------------ runners

def _equal_episodes(a, b):
    for x, y in zip(a.detections, b.detections):
        assert torch.equal(x, y)
    for s, t in ((a.memory, b.memory), (a.first_memory, b.first_memory)):
        assert torch.equal(s.features, t.features)
        assert torch.equal(s.obs_count, t.obs_count)
    assert torch.equal(a.any_detection, b.any_detection)


def test_pipelined_runner_equals_single_runner_and_jax(fx):
    cfg, jmodel, port = _mode(fx, test_type="longterm")
    resets, starts = [True, False, False, False], [True, False, True, False]
    frames, jframes = _frames(fx, resets, starts)
    mem, jmem0 = _memory(fx, seed=3)
    trunk_fn, scan_fn = tdet.make_pipelined_episode_runner(port, port.cfg)
    feats = trunk_fn(frames.image)
    got = scan_fn(frames, T(fx["zs"]), mem, feats)
    single = tdet.make_episode_runner(port, port.cfg)(frames, T(fx["zs"]),
                                                      mem)
    _equal_episodes(got, single)
    per_frame = tdet.make_episode_runner(
        port, port.cfg, precompute_backbone=False)(frames, T(fx["zs"]), mem)
    _check_episode(per_frame, _jaxify(single))
    j_trunk, j_scan = jax_pipelined_runner(jmodel, cfg)
    j_feats = jax.jit(j_trunk)(fx["params"], jframes.image)
    want = jax.jit(j_scan)(fx["params"], jframes, jnp.asarray(fx["zs"]),
                           jmem0, j_feats)
    _check_episode(got, want)
    with pytest.raises(ValueError, match="trunk"):
        scan_fn(frames, T(fx["zs"]), mem)
    with pytest.raises(ValueError, match="precompute_backbone"):
        tdet.make_episode_runner(port, port.cfg, precompute_backbone="yes")


def _jaxify(out):
    """A port EpisodeOutputs as the JAX package's arrays."""
    return types.SimpleNamespace(
        detections=JaxDetections(*[jnp.asarray(_np(x))
                                   for x in out.detections]),
        memory=JaxMemory(*[jnp.asarray(_np(x)) for x in out.memory]),
        first_memory=JaxMemory(*[jnp.asarray(_np(x))
                                 for x in out.first_memory]),
        any_detection=jnp.asarray(_np(out.any_detection)))


def test_batched_runner_equals_single_runs_and_jax(fx):
    """B = 2 streams, each with its own memory (zeros and a random one)
    and its own resets: the same as two single runs, and as JAX's batched
    runner (a vmap over the streams)."""
    cfg, jmodel, port = _mode(fx, test_type="longterm")
    resets = [[True, False, False], [False, False, True]]
    starts = [[True, False, True], [True, False, True]]
    frames, jframes = _frames(fx, resets, starts)
    (m0, j0), (m1, j1) = _memory(fx), _memory(fx, seed=4)
    mem = MemoryState(*(torch.stack(x) for x in zip(m0, m1)))
    jmem0 = JaxMemory(*(jnp.stack(x) for x in zip(j0, j1)))
    got = tdet.make_batched_episode_runner(port, port.cfg)(
        frames, T(fx["zs"]), mem)
    assert got.detections.boxes.shape == (2, 3, 16, 4)
    assert got.memory.features.shape == (2,) + m0.features.shape
    single = tdet.make_episode_runner(port, port.cfg)
    trunk_exact = all(torch.equal(a.flatten(0, 1), b) for a, b in zip(
        _batched_trunk(port, frames), port.backbone_raw(
            frames.image.flatten(0, 1))))
    for b, m in enumerate((m0, m1)):
        one = single(tdet._frame(frames, b), T(fx["zs"]), m)
        part = types.SimpleNamespace(
            detections=Detections(*(x[b] for x in got.detections)),
            memory=MemoryState(*(x[b] for x in got.memory)),
            first_memory=MemoryState(*(x[b] for x in got.first_memory)),
            any_detection=got.any_detection[b])
        if trunk_exact:
            _equal_episodes(part, one)
        else:
            _check_episode(part, _jaxify(one))
    want = jax.jit(jax_batched_runner(jmodel, cfg))(
        fx["params"], jframes, jnp.asarray(fx["zs"]), jmem0)
    for b in range(2):
        _check_episode(
            types.SimpleNamespace(
                detections=Detections(*(x[b] for x in got.detections)),
                memory=MemoryState(*(x[b] for x in got.memory)),
                first_memory=MemoryState(*(x[b] for x in got.first_memory)),
                any_detection=got.any_detection[b]),
            types.SimpleNamespace(
                detections=JaxDetections(*(x[b] for x in want.detections)),
                memory=JaxMemory(*(x[b] for x in want.memory)),
                first_memory=JaxMemory(*(x[b] for x in want.first_memory)),
                any_detection=want.any_detection[b]))


def _batched_trunk(port, frames):
    """The trunk of each stream's chunk, run on its own."""
    with torch.no_grad():
        per = [port.backbone_raw(frames.image[b])
               for b in range(frames.image.shape[0])]
    return [torch.stack(x) for x in zip(*per)]


# ------------------------------------------------------------ config, table

@pytest.mark.parametrize("memory", [
    dict(test_type="default"), dict(test_type="episodic"),
    dict(test_type="longterm"), dict(memory_type="semantic_gt"),
    dict(memory_type="map_gt"), dict(memory_type="explicit_map"),
    dict(memory_type="semantic_gt", test_type="longterm")])
def test_check_slice_config_accepts_the_modes(memory):
    cfg = port_config.DetectorConfig()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory, **memory))
    assert port_config.check_slice_config(cfg) is cfg


def test_check_slice_config_rejects_an_unknown_protocol():
    cfg = port_config.DetectorConfig()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                 test_type="long_term"))
    with pytest.raises(ValueError, match="'default'/'episodic'/'longterm'"):
        port_config.check_slice_config(cfg)
    with pytest.raises(ValueError, match="long_term"):
        tdet.EmbodiedDetector(cfg)


def test_external_memory_state_pads_like_jax(fx):
    cfg = _port_config(fx["cfg"])
    table, obs = _table(fx, 23, seed=9)
    for kwargs in (dict(), dict(observations=obs)):
        got = external_memory_state(table, cfg, device="cpu", **kwargs)
        chunk = types.SimpleNamespace(memory_features=table,
                                      observations=kwargs.get("observations"))
        want = jax_external_memory_state(chunk, fx["cfg"])
        assert got.features.shape == (cfg.memory.max_cells,
                                      cfg.memory.memory_dim)
        assert np.array_equal(_np(got.features), np.asarray(want.features))
        assert np.array_equal(_np(got.obs_count), np.asarray(want.obs_count))
        assert got.features.dtype == got.obs_count.dtype == torch.float32
    assert not got.features[23:].any() and not got.obs_count[23:].any()


@pytest.mark.parametrize("bad", ["missing", "too_large", "wrong_width",
                                 "observations"])
def test_external_memory_state_raises_like_jax(fx, bad):
    cfg = _port_config(fx["cfg"])
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    table = {"missing": None,
             "too_large": np.zeros((cells + 1, d), F32),
             "wrong_width": np.zeros((8, d + 1), F32),
             "observations": np.zeros((8, d), F32)}[bad]
    obs = np.ones(7, F32) if bad == "observations" else None
    chunk = types.SimpleNamespace(memory_features=table, observations=obs)
    with pytest.raises(ValueError) as got:
        external_memory_state(chunk, cfg, device="cpu")
    if bad != "observations":
        with pytest.raises(ValueError) as want:
            jax_external_memory_state(chunk, fx["cfg"])
        assert str(got.value) == str(want.value)
