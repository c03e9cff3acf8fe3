"""Fused 3x3 conv + BN-affine + LeakyReLU on the flat channel-major layout
(port of `kd6d_pose_adlp_tpu/ops/conv_pallas.py`).

Layout contract (unchanged from the JAX package): a map of logical (H, W)
lives in a (C, H*Wp) slab, Wp = W + 2; logical (h, w) sits at flat index
h*Wp + w and the last two columns of each row hold wrap-around garbage. The
input slab is height-padded and 2-element tail-padded, (C, (H+2)*Wp + 2), so
all nine tap shifts dy*Wp + dx stay in bounds.

The two TPU kernels become one CUDA source, `csrc/conv3x3_bn_act.cu`, with
two entry points:

- `conv3x3_bn_act_flat`    (K2, `conv_pallas.py:105`)
- `conv3x3_bn_act_stacked` (K3, `conv_pallas.py:178`)

Types (JAX's contract, `conv_pallas.py:142,296-303`): x and wmat are both
float32 or both bfloat16, scale and bias float32; the sum is accumulated in
float32 and the output has x's dtype, rounded once. Each source has a
float32 and a bfloat16 entry point for each form.

Each wrapper checks its inputs and calls its custom op (`torch.ops.kd6d.*`,
registered at import with a fake implementation that gives the output's
shape and dtype), so that `torch.export` records the kernel as one node of
the graph. On a CUDA tensor the op allocates its output with `torch.empty`,
launches the kernel on PyTorch's current stream and counts the launch in
`launches` under (kernel name, C, O, dtype name), also when it is called
from a loaded exported program. K2 takes any width: where the window of
two image rows that its implicit GEMM stages for a tile does not fit in
shared memory, the launch runs `conv3x3_rows` on the plan `rows_plan`
works out here from the shape and the card's SM count, and counts under the
name `conv3x3_bn_act_flat_rows`. For CPU tensors (and only for them) it runs
the plain PyTorch version beside it, which computes the same flat formula,
garbage columns included, in float32 from the inputs' values and rounds its
result to x's dtype once. A CUDA tensor of any other type raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import cuda_build

# kernel launches since the last reset, keyed (kernel name, C, O, dtype
# name: "float32" or "bfloat16")
launches: collections.Counter = collections.Counter()
# the name K2's launches count under where they run conv3x3_rows (past the
# width where the implicit GEMM's window fits)
ROWS_NAME = "conv3x3_bn_act_flat_rows"


def reset_launch_counts():
    launches.clear()


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def nhwc_to_flat(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, (H+2)*(W+2) + 2) zero-padded flat slab."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    flat = xp.permute(0, 3, 1, 2).reshape(B, C, (H + 2) * (W + 2))
    return F.pad(flat, (0, 2))


def flat_to_nhwc(y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, O, H*(W+2)) output slab -> (B, H, W, O), garbage columns dropped."""
    B, O, _ = y.shape
    return y.reshape(B, O, H, W + 2)[:, :, :, :W].permute(0, 2, 3, 1)


def pack_weights(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, O) HWIO kernel -> (9, O, C): wmat[dy*3+dx, o, c] = k[dy, dx, c, o]."""
    kh, kw, C, O = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"kernel {tuple(k.shape)} is not 3x3 HWIO")
    return k.reshape(9, C, O).permute(0, 2, 1).contiguous()


def stack_taps(x_flat: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, C, L) padded slab -> (B, 9, C, M) pre-shifted tap stack."""
    B, C, L = x_flat.shape
    Wp = W + 2
    M = H * Wp
    if L != (H + 2) * Wp + 2:
        raise ValueError(f"slab length {L} != (H+2)*(W+2)+2 for H={H}, W={W}")
    return torch.stack([x_flat[:, :, dy * Wp + dx: dy * Wp + dx + M]
                        for dy in range(3) for dx in range(3)], dim=1)


def _pool_valid(y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """2x2/stride-2 max pool of the VALID columns of an output slab
    -> (B, O, H//2, W//2); the garbage columns never reach the max. An odd
    last row or column is dropped, as flax nn.max_pool with VALID padding
    drops it."""
    B, O, _ = y.shape
    Hh, Wh = H // 2, W // 2
    v = y.reshape(B, O, H, W + 2)[:, :, :2 * Hh, :2 * Wh]
    return v.reshape(B, O, Hh, 2, Wh, 2).amax(dim=(3, 5))


def pool2x2_flat(y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Max pool an output slab into the next conv's zero-padded input slab:
    (B, O, H*(W+2)) -> (B, O, (H//2+2)*(W//2+2)+2)."""
    B, O, _ = y.shape
    vp = F.pad(_pool_valid(y, H, W), (1, 1, 1, 1))
    flat = vp.reshape(B, O, (H // 2 + 2) * (W // 2 + 2))
    return F.pad(flat, (0, 2))


def pool2x2_slab_to_nhwc(y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Max pool an output slab and convert: (B, O, H*(W+2)) -> (B, H//2, W//2, O)."""
    return _pool_valid(y, H, W).permute(0, 2, 3, 1)


def repad_flat(y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """An output slab as the next conv's zero-padded input slab at the same
    size: (B, O, H*(W+2)) -> (B, O, (H+2)*(W+2)+2), garbage columns dropped."""
    B, O, _ = y.shape
    v = F.pad(y.reshape(B, O, H, W + 2)[:, :, :, :W], (1, 1, 1, 1))
    return F.pad(v.reshape(B, O, (H + 2) * (W + 2)), (0, 2))


def flat_slab_to_nhwc(x_flat: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Logical (B, H, W, C) view of a zero-padded INPUT slab (the inverse of
    nhwc_to_flat; no copy)."""
    B, C, _ = x_flat.shape
    grid = x_flat[:, :, :(H + 2) * (W + 2)].reshape(B, C, H + 2, W + 2)
    return grid[:, :, 1:H + 1, 1:W + 1].permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# plain versions (CPU path of the wrappers; the card's oracle)
# ---------------------------------------------------------------------------

def _affine_act(acc, scale, bias, alpha, dtype):
    acc = acc * scale.float() + bias.float()
    return torch.where(acc >= 0, acc, alpha * acc).to(dtype)


def conv3x3_bn_act_flat_plain(x_flat, wmat, scale, bias, *, H: int, W: int,
                              alpha: float = 0.1) -> torch.Tensor:
    """Nine accumulated (O, C) @ (C, M) tap products in float32, then
    affine + act, rounded to x_flat's dtype."""
    Wp = W + 2
    M = H * Wp
    x32, w32 = x_flat.float(), wmat.float()
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        off = dy * Wp + dx
        prod = torch.matmul(w32[tap], x32[:, :, off:off + M])
        acc = prod if acc is None else acc + prod
    return _affine_act(acc, scale, bias, alpha, x_flat.dtype)


def conv3x3_bn_act_stacked_plain(xs, wmat, scale, bias, *,
                                 alpha: float = 0.1) -> torch.Tensor:
    x32, w32 = xs.float(), wmat.float()
    acc = None
    for tap in range(9):
        prod = torch.matmul(w32[tap], x32[:, tap])
        acc = prod if acc is None else acc + prod
    return _affine_act(acc, scale, bias, alpha, xs.dtype)


def conv3x3_bn_act_ref(x, k, scale, bias, alpha: float = 0.1) -> torch.Tensor:
    """Library-conv oracle with the same semantics, NHWC in/out; k HWIO,
    cast to x's dtype. In bfloat16 the conv's result is rounded to
    bfloat16 before the float32 affine, then the output once more."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    y = y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)
    return F.leaky_relu(y, alpha).permute(0, 2, 3, 1).to(x.dtype)


# ---------------------------------------------------------------------------
# conv3x3_rows' launch plan
# ---------------------------------------------------------------------------

# The layout of csrc/conv3x3_bn_act.cu's conv3x3_rows (RowsCfg there, which
# checks a plan's shared memory against its own): a tile is ROWS_PIX output
# columns, `rows` image rows of ROWS_PIX // rows; a block keeps `cw` channel
# octets of weights (B fragments, fp32 split hi / lo), a ring of input
# strips, and where a cluster of ks > 1 blocks splits the octets, its
# partial sums.
ROWS_PIX = 256
ROWS_TILE_ROWS = (1, 2, 4, 8)
ROWS_NTS = (1, 2, 4)             # n tiles of 8 outputs a pass (the source's instances)
_ROWS_SMEM_MAX = 227 * 1024      # a block's shared memory on an H100
_SM_SMEM = 228 * 1024            # an SM's, of which a block reserves 1 KB more
_ROWS_MAX_CLUSTER = 8            # the portable cluster size

RowsPlan = collections.namedtuple("RowsPlan", "nt rows ks grid ngo cw smem")
RowsPlan.__doc__ = """conv3x3_rows' launch: nt n tiles of 8 outputs a pass, tiles of
`rows` image rows, clusters of ks blocks splitting the channel octets,
`grid` clusters (a multiple of ngo, the output groups), cw octets of
weights a block holds at a time, `smem` bytes of shared memory a block."""


def rows_kind(C: int, dtype_name: str) -> str:
    """conv3x3_rows' kind: "bf16", "quad" (fp32 at C <= 4, two taps a k8
    step) or "f32"."""
    return "bf16" if dtype_name == "bfloat16" else ("quad" if C <= 4 else "f32")


def rows_octets(C: int, kind: str) -> int:
    """Reduction stages of a tile: channel octets (one stage at "quad")."""
    return 1 if kind == "quad" else -(-C // 8)


def rows_smem(kind: str, nt: int, rows: int, ks: int, cw: int) -> int:
    """Shared memory bytes of a conv3x3_rows block (RowsCfg): cw octets of
    B fragments, the ring of strips ((rows + 2) row segments of
    ROWS_PIX // rows + 2 columns: fp32 channel rows 8 words mod 32 apart,
    bf16 16-byte columns of 8 channels) and, for ks > 1, the partial sums."""
    rs = (rows + 2) * (ROWS_PIX // rows + 2)
    if kind == "bf16":
        wbytes, strip, bufs = 5 * nt * 32 * 8, 16 * rs, 2
    else:
        steps, ch = (5, 4) if kind == "quad" else (9, 8)
        wbytes, strip, bufs = steps * nt * 32 * 16, ch * 4 * ((rs - 8 + 31) // 32 * 32 + 8), 3
    return cw * wbytes + bufs * strip + (256 * 2 * nt * 4 * 4 if ks > 1 else 0)


@functools.lru_cache(maxsize=None)
def rows_plan(B: int, C: int, O: int, H: int, W: int, dtype_name: str,
              sms: int) -> RowsPlan:
    """conv3x3_rows' plan for a (B, C, H, W) slab into O outputs on a card
    of `sms` SMs. The most n tiles a pass (fp32 at C > 4, on wgmma, two at
    least where O allows) and the smallest cluster whose blocks number 45%
    of the SMs at least, else the plan with the most blocks; among
    tile heights (no taller than the image) the one a time model ranks
    first: rounds of the resident clusters over the tiles, each a stage an
    octet (its products, its strip's columns staged) and a fixed part.
    Fitted to the four-row K2_WIDE shapes on an H100 (PERF.md §6),
    where a block's fixed latency dominates: more output groups or larger
    clusters than that filled the card no better and each block paid it
    again."""
    kind = rows_kind(C, dtype_name)
    n8 = rows_octets(C, kind)
    need = 1 if O <= 8 else 2 if O <= 16 else 4
    steps, ch = {"f32": (9, 8), "quad": (5, 4), "bf16": (5, 8)}[kind]
    fits = [n for n in ROWS_NTS if n <= need and (kind != "f32" or n >= min(2, need))]
    heights = [r for r in ROWS_TILE_ROWS if r <= H] or [1]
    target = max(1, sms * 9 // 20)
    most = None
    for nt in sorted(fits, reverse=True):
        ngo = -(-O // (8 * nt))
        wbytes = rows_smem(kind, nt, 1, 1, 1) - rows_smem(kind, nt, 1, 1, 0)
        for ks in range(1, min(_ROWS_MAX_CLUSTER, n8) + 1):
            per = -(-n8 // ks)
            best = None
            for rows in heights:
                cols = ROWS_PIX // rows
                tiles = B * -(-H // rows) * -(-(W + 2) // cols)
                fixed = rows_smem(kind, nt, rows, ks, 0)
                cw = min(per, (_ROWS_SMEM_MAX - fixed) // wbytes)
                if cw < 1:
                    continue
                smem = fixed + cw * wbytes
                per_sm = min(2, _SM_SMEM // (smem + 1024))
                clusters = min(tiles, max(1, sms * per_sm // (ks * ngo)))
                stage = steps * nt * 60 + ch * (rows + 2) * (cols + 2) // 4
                cost = tiles / clusters * (per * stage + (per * nt * 100 if cw < per else 0)
                                           + 1000)
                if best is None or (cost, -rows) < best[0]:
                    best = ((cost, -rows), RowsPlan(nt, rows, ks, ngo * clusters, ngo, cw,
                                                    smem))
            if best is None:
                continue
            plan = best[1]
            if plan.grid * ks >= target:
                return plan
            if most is None or plan.grid * ks > most.grid * most.ks:
                most = plan
    return most


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernels with their C signatures declared."""
    lib = cuda_build.load("conv3x3_bn_act")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for suffix in ("", "_bf16"):
        flat = getattr(lib, "conv3x3_bn_act_flat" + suffix)
        stacked = getattr(lib, "conv3x3_bn_act_stacked" + suffix)
        flat.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p, p, p]
        stacked.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
        flat.restype = stacked.restype = i
    return lib


# the C entry point's suffix for each slab dtype
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check(x, wmat, scale, bias, C: int, O: int):
    if wmat.shape != (9, O, C):
        raise ValueError(f"wmat {tuple(wmat.shape)} != (9, {O}, {C})")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape not in ((O, 1), (O,)):
            raise ValueError(f"{name} {tuple(t.shape)} is not ({O}, 1)")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t, want in (("wmat", wmat, x.dtype), ("scale", scale, torch.float32),
                          ("bias", bias, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} with a {x.dtype} x, got {t.dtype}")
    for name, t in (("wmat", wmat), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        for name, t in (("x", x), ("wmat", wmat), ("scale", scale),
                        ("bias", bias)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def conv3x3_bn_act_flat(x_flat, wmat, scale, bias, *, H: int, W: int,
                        alpha: float = 0.1) -> torch.Tensor:
    """Fused 3x3 conv (stride 1, SAME) + affine + LeakyReLU, flat layout (K2).

    x_flat (B, C, (H+2)*(W+2)+2) from nhwc_to_flat; wmat (9, O, C) from
    pack_weights, x_flat's dtype; scale, bias (O, 1) float32 folded BN
    affine -> (B, O, H*(W+2)) in x_flat's dtype; the 2 pad columns per row
    hold wrap-around values. The call is the custom op
    `torch.ops.kd6d.conv3x3_bn_act_flat`, so `torch.export` records it as
    one node and a loaded program launches the kernel through it.
    """
    B, C, L = x_flat.shape
    Wp = W + 2
    if L != (H + 2) * Wp + 2:
        raise ValueError(f"slab length {L} != (H+2)*(W+2)+2 for H={H}, W={W}")
    O = wmat.shape[1]
    _check(x_flat, wmat, scale, bias, C, O)
    return torch.ops.kd6d.conv3x3_bn_act_flat(x_flat, wmat, scale.reshape(O, 1),
                                              bias.reshape(O, 1), H, W, alpha)


@torch.library.custom_op("kd6d::conv3x3_bn_act_flat", mutates_args=())
def _flat_op(x_flat: torch.Tensor, wmat: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, H: int, W: int, alpha: float) -> torch.Tensor:
    """K2 on a CUDA tensor (counted in `launches`), its plain version on a
    CPU one."""
    if x_flat.device.type == "cpu":
        return conv3x3_bn_act_flat_plain(x_flat, wmat, scale, bias, H=H, W=W,
                                         alpha=alpha)
    _check(x_flat, wmat, scale, bias, x_flat.shape[1], wmat.shape[1])
    B, C, _ = x_flat.shape
    O = wmat.shape[1]
    out = torch.empty((B, O, H * (W + 2)), device=x_flat.device, dtype=x_flat.dtype)
    name = "conv3x3_bn_act_flat"
    rows = ctypes.c_int(0)      # set to 1 where conv3x3_rows ran
    plan = rows_plan(B, C, O, H, W, _dtype_name(x_flat), _sm_count(x_flat.device.index))
    with torch.cuda.device(x_flat.device):
        err = getattr(_lib(), name + _SUFFIX[x_flat.dtype])(
            x_flat.data_ptr(), wmat.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, C, O, H, W, alpha,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(rows),
            (ctypes.c_int * len(plan))(*plan))
    _raise_on(err, name + _SUFFIX[x_flat.dtype])
    launches[(ROWS_NAME if rows.value else name, C, O, _dtype_name(x_flat))] += 1
    return out


@_flat_op.register_fake
def _(x_flat, wmat, scale, bias, H, W, alpha):
    return x_flat.new_empty((x_flat.shape[0], wmat.shape[1], H * (W + 2)))


def conv3x3_bn_act_stacked(xs, wmat, scale, bias, *,
                           alpha: float = 0.1) -> torch.Tensor:
    """The same op over a pre-shifted tap stack xs (B, 9, C, M) (K3), the
    custom op `torch.ops.kd6d.conv3x3_bn_act_stacked`."""
    B, nine, C, M = xs.shape
    if nine != 9:
        raise ValueError(f"xs {tuple(xs.shape)} is not (B, 9, C, M)")
    O = wmat.shape[1]
    _check(xs, wmat, scale, bias, C, O)
    return torch.ops.kd6d.conv3x3_bn_act_stacked(xs, wmat, scale.reshape(O, 1),
                                                 bias.reshape(O, 1), alpha)


@torch.library.custom_op("kd6d::conv3x3_bn_act_stacked", mutates_args=())
def _stacked_op(xs: torch.Tensor, wmat: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, alpha: float) -> torch.Tensor:
    """K3 on a CUDA tensor (counted in `launches`), its plain version on a
    CPU one."""
    if xs.device.type == "cpu":
        return conv3x3_bn_act_stacked_plain(xs, wmat, scale, bias, alpha=alpha)
    B, _, C, M = xs.shape
    O = wmat.shape[1]
    _check(xs, wmat, scale, bias, C, O)
    out = torch.empty((B, O, M), device=xs.device, dtype=xs.dtype)
    name = "conv3x3_bn_act_stacked"
    with torch.cuda.device(xs.device):
        err = getattr(_lib(), name + _SUFFIX[xs.dtype])(
            xs.data_ptr(), wmat.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, C, O, M, alpha,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name + _SUFFIX[xs.dtype])
    launches[(name, C, O, _dtype_name(xs))] += 1
    return out


@_stacked_op.register_fake
def _(xs, wmat, scale, bias, alpha):
    return xs.new_empty((xs.shape[0], wmat.shape[1], xs.shape[3]))


# ---------------------------------------------------------------------------
# the serving-stem segment
# ---------------------------------------------------------------------------

def _segment(x, w1, sc1, bi1, w2, sc2, bi2, alpha, stacked, pool_first,
             flat_fn, stacked_fn):
    B, H, W, C = x.shape
    n_pool = 2 if pool_first else 1
    if H < 2 * n_pool or W < 2 * n_pool:
        raise ValueError(f"stem segment needs H, W >= {2 * n_pool} ({n_pool} 2x2 "
                         f"pools), got {H}x{W}")
    xf = nhwc_to_flat(x)
    if stacked:
        y1 = stacked_fn(stack_taps(xf, H, W), w1, sc1, bi1, alpha=alpha)
    else:
        y1 = flat_fn(xf, w1, sc1, bi1, H=H, W=W, alpha=alpha)
    if pool_first:
        x2, H2, W2 = pool2x2_flat(y1, H, W), H // 2, W // 2
    else:
        x2, H2, W2 = repad_flat(y1, H, W), H, W
    if stacked:
        y2 = stacked_fn(stack_taps(x2, H2, W2), w2, sc2, bi2, alpha=alpha)
    else:
        y2 = flat_fn(x2, w2, sc2, bi2, H=H2, W=W2, alpha=alpha)
    return flat_slab_to_nhwc(x2, H2, W2), pool2x2_slab_to_nhwc(y2, H2, W2)


def stem_s2_segment_flat(x, w1, sc1, bi1, w2, sc2, bi2, *, alpha: float = 0.1,
                         stacked: bool = False, pool_first: bool = True):
    """The serving-stem segment — stem conv -> pool -> s2 conv -> pool — in
    flat channel-major layout, through the kernels, in x's dtype.

    x (B, H, W, C) NHWC; w1 (9, O1, C), sc1/bi1 (O1, 1); w2 (9, O2, O1),
    sc2/bi2 (O2, 1) -> (pool1 (B, H//2, W//2, O1),
    pool2 (B, (H//2)//2, (W//2)//2, O2)), NHWC views; each pool floors odd
    maps as flax's VALID max pool does. pool2 is what the JAX
    `stem_s2_segment_flat` returns; pool1 is the darknet pyramid's first map.
    pool_first=False is the space-to-depth stem's form, stem conv -> s2
    conv -> pool: (stem conv's map (B, H, W, O1), pool2 (B, H//2, W//2, O2)).
    """
    return _segment(x, w1, sc1, bi1, w2, sc2, bi2, alpha, stacked, pool_first,
                    conv3x3_bn_act_flat, conv3x3_bn_act_stacked)


def stem_s2_segment_flat_plain(x, w1, sc1, bi1, w2, sc2, bi2, *,
                               alpha: float = 0.1, stacked: bool = False,
                               pool_first: bool = True):
    """stem_s2_segment_flat through the plain versions, on any device."""
    return _segment(x, w1, sc1, bi1, w2, sc2, bi2, alpha, stacked, pool_first,
                    conv3x3_bn_act_flat_plain, conv3x3_bn_act_stacked_plain)
