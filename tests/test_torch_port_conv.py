"""PyTorch port, fused conv module (`kd6d_pose_adlp_tpu_torch/ops/conv_fused.py`)
against the JAX Pallas kernels of `kd6d_pose_adlp_tpu/ops/conv_pallas.py`,
run here in interpret mode on the same seeded numpy inputs.

On CPU tensors the wrappers run their plain PyTorch versions (the CUDA
kernels build and run only on the card; `chip_smoke.py` holds them against
these plain versions there). Tolerances, with the largest difference
measured on this CPU beside them:
  layout helpers                exact            (0)
  K2 / K3 vs Pallas interpret   atol=rtol=1e-5   (max abs 3.3e-6; 9.5e-7 at
                                                   the K3 edge shapes)
  stem segment vs Pallas        atol=1e-5        (max 2.4e-6)
  pooled stage-1 vs library     atol=1e-5        (max 1.4e-6)
  odd-sized segment vs library  atol=1e-5        (max 1.9e-6)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu.ops import conv_pallas as J
from kd6d_pose_adlp_tpu_torch.ops import conv_fused as T

# (B, H, W, C, O): the serving stem's (3, 8) and (8, 16) instances, a shape
# outside them, then the edges of the card kernel's mapping: M = H * (W + 2)
# odd with (W + 2) % 4 = 3 and 1, and a (C, O) outside the tiled instances;
# then chip_smoke's K3_EDGES: each serving instance at B = 1 and full size,
# odd M at both, a ragged tile at 30², and the eval stems of darknet ref and
# tiny (3 -> 16, 16 -> 32); then the shapes and mapping edges of the card's
# implicit GEMM (conv3x3_igemm): the variants' 3 -> 32, 32 -> 32, 32 -> 64
# and 12 -> 8, a partial channel octet with O past 64 (20 -> 72), odd M
# (24 -> 24 at 9 x 11); then widths where the card's fp32 K2 runs
# conv3x3_rows (past the width where the implicit GEMM's window fits), at
# C > 4 and C <= 4
SHAPES = [(2, 16, 16, 3, 8), (2, 12, 20, 8, 16), (1, 8, 8, 16, 64),
          (1, 15, 17, 3, 8), (3, 9, 7, 8, 16), (2, 9, 7, 5, 12),
          (1, 256, 256, 3, 8), (1, 128, 128, 8, 16), (1, 41, 61, 3, 8),
          (3, 67, 61, 8, 16), (2, 30, 30, 8, 16), (2, 64, 64, 3, 16),
          (2, 32, 32, 16, 32),
          (1, 24, 24, 3, 32), (1, 16, 16, 32, 32), (1, 12, 12, 32, 64),
          (2, 16, 16, 12, 8), (1, 10, 13, 20, 72), (1, 9, 11, 24, 24),
          (1, 4, 1000, 32, 32), (1, 4, 900, 32, 64), (1, 4, 2200, 3, 32)]


def _inputs(seed, B, H, W, C, O):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    k = (rng.normal(size=(3, 3, C, O)) * 0.1).astype(np.float32)
    sc = (rng.normal(size=(O, 1)) * 0.5 + 1.0).astype(np.float32)
    bi = (rng.normal(size=(O, 1)) * 0.1).astype(np.float32)
    return x, k, sc, bi


def test_layout_helpers_equal_jax():
    rng = np.random.default_rng(0)
    B, H, W, C, O = 2, 10, 14, 8, 6
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    xf_j = J.nhwc_to_flat(jnp.asarray(x))
    xf_t = T.nhwc_to_flat(torch.from_numpy(x))
    np.testing.assert_array_equal(xf_t.numpy(), np.asarray(xf_j))
    np.testing.assert_array_equal(T.stack_taps(xf_t, H, W).numpy(),
                                  np.asarray(J.stack_taps(xf_j, H, W)))
    np.testing.assert_array_equal(T.flat_slab_to_nhwc(xf_t, H, W).numpy(), x)
    k = rng.normal(size=(3, 3, C, O)).astype(np.float32)
    np.testing.assert_array_equal(T.pack_weights(torch.from_numpy(k)).numpy(),
                                  np.asarray(J.pack_weights(jnp.asarray(k))))
    y = rng.normal(size=(B, O, H * (W + 2))).astype(np.float32)
    yj, yt = jnp.asarray(y), torch.from_numpy(y)
    np.testing.assert_array_equal(T.flat_to_nhwc(yt, H, W).numpy(),
                                  np.asarray(J.flat_to_nhwc(yj, H, W)))
    np.testing.assert_array_equal(T.pool2x2_flat(yt, H, W).numpy(),
                                  np.asarray(J.pool2x2_flat(yj, H, W)))
    np.testing.assert_array_equal(T.pool2x2_slab_to_nhwc(yt, H, W).numpy(),
                                  np.asarray(J.pool2x2_slab_to_nhwc(yj, H, W)))


def test_garbage_columns_never_reach_the_pool():
    """The 2 wrap-around columns per output row must not leak into the
    pooled map: planting huge values there changes nothing."""
    rng = np.random.default_rng(1)
    B, O, H, W = 1, 4, 8, 6
    y = torch.from_numpy(rng.normal(size=(B, O, H * (W + 2))).astype(np.float32))
    dirty = y.clone().reshape(B, O, H, W + 2)
    dirty[..., W:] = 1e6
    dirty = dirty.reshape(B, O, -1)
    np.testing.assert_array_equal(T.pool2x2_flat(dirty, H, W).numpy(),
                                  T.pool2x2_flat(y, H, W).numpy())
    np.testing.assert_array_equal(T.pool2x2_slab_to_nhwc(dirty, H, W).numpy(),
                                  T.pool2x2_slab_to_nhwc(y, H, W).numpy())


@pytest.mark.parametrize("B,H,W,C,O", SHAPES)
def test_flat_matches_pallas_interpret(B, H, W, C, O):
    """All columns, garbage included: both sides compute the same flat
    formula. Valid columns also against the library conv."""
    x, k, sc, bi = _inputs(0, B, H, W, C, O)
    xf = J.nhwc_to_flat(jnp.asarray(x))
    want = J.conv3x3_bn_act_flat(xf, J.pack_weights(jnp.asarray(k)),
                                 jnp.asarray(sc), jnp.asarray(bi), H=H, W=W,
                                 interpret=True)
    got = T.conv3x3_bn_act_flat(T.nhwc_to_flat(torch.from_numpy(x)),
                                T.pack_weights(torch.from_numpy(k)),
                                torch.from_numpy(sc), torch.from_numpy(bi), H=H, W=W)
    assert got.shape == (B, O, H * (W + 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    ref = T.conv3x3_bn_act_ref(torch.from_numpy(x), torch.from_numpy(k),
                               torch.from_numpy(sc), torch.from_numpy(bi))
    np.testing.assert_allclose(T.flat_to_nhwc(got, H, W).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,W,C,O", SHAPES)
def test_stacked_matches_pallas_interpret(B, H, W, C, O):
    x, k, sc, bi = _inputs(7, B, H, W, C, O)
    xs = J.stack_taps(J.nhwc_to_flat(jnp.asarray(x)), H, W)
    want = J.conv3x3_bn_act_stacked(xs, J.pack_weights(jnp.asarray(k)),
                                    jnp.asarray(sc), jnp.asarray(bi), interpret=True)
    got = T.conv3x3_bn_act_stacked(
        T.stack_taps(T.nhwc_to_flat(torch.from_numpy(x)), H, W),
        T.pack_weights(torch.from_numpy(k)), torch.from_numpy(sc),
        torch.from_numpy(bi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stacked", [False, True])
def test_stem_segment_matches_jax(stacked):
    rng = np.random.default_rng(3)
    B, H, W = 2, 32, 24
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    k1 = (rng.normal(size=(3, 3, 3, 8)) * 0.3).astype(np.float32)
    k2 = (rng.normal(size=(3, 3, 8, 16)) * 0.2).astype(np.float32)
    s1, b1 = rng.uniform(0.5, 1.5, (8, 1)), rng.normal(0, 0.1, (8, 1))
    s2, b2 = rng.uniform(0.5, 1.5, (16, 1)), rng.normal(0, 0.1, (16, 1))
    s1, b1, s2, b2 = (a.astype(np.float32) for a in (s1, b1, s2, b2))
    want = J.stem_s2_segment_flat(
        jnp.asarray(x), J.pack_weights(jnp.asarray(k1)), s1, b1,
        J.pack_weights(jnp.asarray(k2)), s2, b2, interpret=True, stacked=stacked)
    t = torch.from_numpy
    p1, p2 = T.stem_s2_segment_flat(t(x), T.pack_weights(t(k1)), t(s1), t(b1),
                                    T.pack_weights(t(k2)), t(s2), t(b2),
                                    stacked=stacked)
    assert p2.shape == (B, H // 4, W // 4, 16)
    np.testing.assert_allclose(p2.numpy(), np.asarray(want), atol=1e-5)
    ref1 = torch.nn.functional.max_pool2d(
        T.conv3x3_bn_act_ref(t(x), t(k1), t(s1), t(b1)).permute(0, 3, 1, 2), 2)
    np.testing.assert_allclose(p1.numpy(), ref1.permute(0, 2, 3, 1).numpy(), atol=1e-5)
    plain = T.stem_s2_segment_flat_plain(t(x), T.pack_weights(t(k1)), t(s1), t(b1),
                                         T.pack_weights(t(k2)), t(s2), t(b2),
                                         stacked=stacked)
    np.testing.assert_array_equal(plain[1].numpy(), p2.numpy())


@pytest.mark.parametrize("stacked", [False, True])
def test_stem_segment_floors_odd_maps(stacked):
    """Odd H, W: each pool drops the odd last row/column, as flax's VALID
    max pool (and F.max_pool2d) do, so the segment equals the library chain
    conv -> pool -> conv -> pool at any size it takes."""
    rng = np.random.default_rng(4)
    B, H, W = 2, 19, 14                     # 19 -> 9 -> 4, 14 -> 7 -> 3
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = t(rng.normal(size=(B, H, W, 3)))
    k1, k2 = t(rng.normal(size=(3, 3, 3, 8)) * 0.3), t(rng.normal(size=(3, 3, 8, 16)) * 0.2)
    s1, b1 = t(rng.uniform(0.5, 1.5, (8, 1))), t(rng.normal(0, 0.1, (8, 1)))
    s2, b2 = t(rng.uniform(0.5, 1.5, (16, 1))), t(rng.normal(0, 0.1, (16, 1)))
    p1, p2 = T.stem_s2_segment_flat(x, T.pack_weights(k1), s1, b1,
                                    T.pack_weights(k2), s2, b2, stacked=stacked)
    pool = lambda y: torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    ref1 = pool(T.conv3x3_bn_act_ref(x, k1, s1, b1))
    ref2 = pool(T.conv3x3_bn_act_ref(ref1, k2, s2, b2))
    assert p1.shape == (B, 9, 7, 8) and p2.shape == (B, 4, 3, 16)
    np.testing.assert_allclose(p1.numpy(), ref1.numpy(), atol=1e-5)
    np.testing.assert_allclose(p2.numpy(), ref2.numpy(), atol=1e-5)


def test_stem_segment_rejects_maps_below_two_pools():
    x = torch.zeros((1, 3, 8, 3))
    w1, w2 = torch.zeros((9, 8, 3)), torch.zeros((9, 16, 8))
    s1, s2 = torch.ones((8, 1)), torch.ones((16, 1))
    with pytest.raises(ValueError):
        T.stem_s2_segment_flat(x, w1, s1, s1, w2, s2, s2)


def test_cpu_wrappers_do_not_count_launches():
    T.reset_launch_counts()
    x, k, sc, bi = _inputs(0, 1, 8, 8, 3, 8)
    xf = T.nhwc_to_flat(torch.from_numpy(x))
    w = T.pack_weights(torch.from_numpy(k))
    T.conv3x3_bn_act_flat(xf, w, torch.from_numpy(sc), torch.from_numpy(bi), H=8, W=8)
    T.conv3x3_bn_act_stacked(T.stack_taps(xf, 8, 8), w, torch.from_numpy(sc),
                             torch.from_numpy(bi))
    assert not T.launches


def test_wrappers_reject_what_the_kernel_does_not_take():
    x, k, sc, bi = _inputs(0, 1, 8, 8, 3, 8)
    xf = T.nhwc_to_flat(torch.from_numpy(x))
    w, s, b = T.pack_weights(torch.from_numpy(k)), torch.from_numpy(sc), torch.from_numpy(bi)
    with pytest.raises(TypeError):
        T.conv3x3_bn_act_flat(xf.double(), w, s, b, H=8, W=8)
    with pytest.raises(ValueError):
        T.conv3x3_bn_act_flat(xf, w, s, b, H=8, W=9)            # slab length
    with pytest.raises(ValueError):
        T.conv3x3_bn_act_flat(xf, w[:, :, :2], s, b, H=8, W=8)  # weight shape
    with pytest.raises(ValueError):
        T.conv3x3_bn_act_stacked(xf[:, None], w, s, b)          # not 9 taps


@pytest.mark.parametrize("B, C, O, H, elem, want_ms", [
    (8, 3, 8, 256, 2, 0.00347755463), (8, 8, 16, 128, 2, 0.00191812776),
    (24, 3, 8, 256, 2, 0.01043236776), (24, 8, 16, 128, 2, 0.00575293134)])
def test_k2_bound_at_the_bf16_serving_shapes(B, C, O, H, elem, want_ms):
    """The yardstick the bf16 serving instances are timed against on the
    card: chip_smoke.k2_bound at the stem (3 -> 8 @256²) and s2 (8 -> 16
    @128²), at the serving batch and the eval batch. Both are bound by
    bytes: the bf16 slab read once, the bf16 output written once, over the
    H100's 3.35 TB/s."""
    import chip_smoke

    ms, by, nbytes, _ = chip_smoke.k2_bound(B, C, O, H, H, elem=elem)
    Wp = H + 2
    assert nbytes == 2 * B * C * ((H + 2) * Wp + 2) + 2 * 9 * O * C + 8 * O + 2 * B * O * H * Wp
    assert by == "bytes"
    assert ms == pytest.approx(want_ms, rel=1e-8)


def _rows_plan_cover(plan, B, C, O, H, W, kind):
    """What conv3x3_rows (csrc/conv3x3_bn_act.cu) computes on `plan`, by
    its own index arithmetic: (how often each output (group, b, m) is
    written, how often each channel octet reaches each written tile)."""
    rows, ks, ngo = plan.rows, plan.ks, plan.ngo
    cols, Wp = T.ROWS_PIX // rows, W + 2
    n8 = T.rows_octets(C, kind)
    nbands, nchunks = -(-H // rows), -(-Wp // cols)
    ntiles = B * nbands * nchunks
    written = np.zeros((ngo, B, H * Wp), np.int64)
    octets = []
    ncl = plan.grid
    tstep = ncl // ngo
    for cl in range(ncl):
        grp, t0 = cl % ngo, cl // ngo
        # each rank's octets [r n8 / ks, (r + 1) n8 / ks)
        got = np.zeros(n8, np.int64)
        for r in range(ks):
            got[r * n8 // ks:(r + 1) * n8 // ks] += 1
        ntl = (ntiles - 1 - t0) // tstep + 1 if t0 < ntiles else 0
        for it in range(ntl):
            t = t0 + it * tstep
            b, rem = divmod(t, nbands * nchunks)
            band, chunk = divmod(rem, nchunks)
            h = band * rows + np.arange(rows)[:, None]
            c = chunk * cols + np.arange(cols)[None, :]
            keep = (h < H) & (c < Wp)
            np.add.at(written[grp, b], (h * Wp + c)[keep], 1)
            octets.append(got)
    return written, octets


@pytest.mark.parametrize("sms", [132, 16])
def test_rows_plan_covers_each_column_and_octet_once(sms):
    """conv3x3_rows' launch plan at chip_smoke's K2_WIDE shapes: every
    output column of every image and output group is written exactly once,
    every written tile sums every channel octet exactly once, the cluster
    splits no fewer than one octet a rank, and a block fits in shared
    memory."""
    import chip_smoke

    for B, C, O, H, W, dname in chip_smoke.K2_WIDE:
        kind = T.rows_kind(C, dname)
        plan = T.rows_plan(B, C, O, H, W, dname, sms)
        n8 = T.rows_octets(C, kind)
        assert plan.ngo == -(-O // (8 * plan.nt)) and plan.grid % plan.ngo == 0
        assert 1 <= plan.ks <= min(8, n8) and plan.cw >= 1
        assert plan.smem == T.rows_smem(kind, plan.nt, plan.rows, plan.ks, plan.cw)
        assert plan.smem <= 227 * 1024
        written, octets = _rows_plan_cover(plan, B, C, O, H, W, kind)
        assert (written == 1).all(), (B, C, O, H, W, dname, sms)
        assert all((o == 1).all() for o in octets)


def test_rows_smem_matches_the_cuda_source(tmp_path):
    """rows_smem (the plan's shared memory, which the source checks on the
    card) against RowsCfg in csrc/conv3x3_bn_act.cu, compiled on the host
    with g++ (the data plane's compiler) for every kind, n tiles, tile
    height, cluster and weight chunk the plans take."""
    import subprocess
    from pathlib import Path

    src = (Path(T.__file__).resolve().parent.parent / "csrc" / "conv3x3_bn_act.cu").read_text()
    start = src.index("constexpr int kRowsWarps")
    cfg = src[start:src.index("};", src.index("struct RowsCfg")) + 2]
    cases = [(kind, nt, rows, ks, cw) for kind in ("f32", "quad", "bf16") for nt in T.ROWS_NTS
             for rows in T.ROWS_TILE_ROWS for ks in (1, 2) for cw in (1, 3)]
    types = {"f32": "float, false", "quad": "float, true", "bf16": "bf16, false"}
    prog = tmp_path / "rows_smem.cpp"
    prog.write_text(
        "#include <cstdio>\n#include <type_traits>\n#define __host__\n#define __device__\n"
        "struct bf16 { unsigned short v; };\n" + cfg + "\nint main() {\n" + "".join(
            f"  {{ using Cfg = RowsCfg<{types[k]}, {nt}>; const int NC = kRowsPix / {r};\n"
            f"    printf(\"%ld\\n\", (long){cw} * Cfg::kWBytes + (long)Cfg::kBufs * "
            f"Cfg::strip_bytes(({r} + 2) * (NC + 2)) + ({ks} > 1 ? Cfg::kRedBytes : 0)); }}\n"
            for k, nt, r, ks, cw in cases) + "}\n")
    exe = tmp_path / "rows_smem"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(prog)], check=True)
    got = [int(v) for v in subprocess.run([str(exe)], check=True, capture_output=True,
                                          text=True).stdout.split()]
    assert got == [T.rows_smem(*c) for c in cases]
