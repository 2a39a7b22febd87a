"""The kernels of a greedy or beam decode step, with their plain twins
(counterpart of adaptive_tpu/ops/pallas/fused_step.py).

* ``decode_cell``: LSTM recurrence + visual sentinel + adaptive attention,
  given the input projection gx = x @ W_ih + b_ih computed outside. With
  beam_w > 1 the rows are batch-major beam copies (row r belongs to image
  r // beam_w) and V/pv come untiled, one copy per image (beam-major).
* ``greedy_head_argmax``: argmax over the real vocab of (chat + h) @ W + b,
  first max on ties, logits never stored.
* ``beam_head_topk``: the same head's top-W values and ids per row, lower
  id first on ties (as lax.top_k), and the row's logsumexp.

Each wrapper launches its CUDA kernel (ops/cuda/csrc/fused_step.cu,
cell_mma.cuh, head_topk.cu) for CUDA tensors, after checking device, dtype,
shape, contiguity and alignment, and raises on anything the kernel does not
take. For CPU tensors it runs the plain PyTorch twin beside it, which is the
arithmetic the kernel must reproduce: fp32 inside, the same casts, the same
-1e30 mask. Each wrapper counts its kernel launches in a plain int
attribute, ``<wrapper>.launches`` (``decode_cell.launches_beam`` for the
beam-major cell, beam_w > 1): one call counts one launch.

Each wrapper's kernel and twin are also an operator of the
``adaptive_tpu_torch`` namespace (``define_op``): the operator's CUDA
implementation is the checked launch and its count, its CPU implementation
the twin, and its fake implementation the output shapes. The launches are
ctypes calls on raw pointers, which ``torch.export`` cannot trace; under a
tracer the wrapper calls the operator, so that an exported decoder
(export.py) records it and runs the same launches, counted, when it is
called. On real tensors the wrapper runs the same implementations without
the dispatcher.

The cell has two instances, picked by ``cell_instance``. In bf16 with H and
E2 multiples of 64, "mma": two kernels that one call starts back to back.
Stage 1 runs the LSTM gates and the sentinel's pre-activation as bf16
tensor-core products with fp32 sums (exact products; only the order of the
sums differs from the twin), a block a band of 64 rows and a slice of 32
hidden units, over the weights reordered once per checkpoint by
``cell_kernel_tiles`` (the prepared tree carries them), and writes h' and s
in fp32 to scratch. Stage 2 runs the attention, a block a group of whole
images with all their beam rows, reading each image's V and pv once; h',
s and alpha keep fp32 (fp32 FMAs), as in the TPU kernel. ``cell_plan``
picks the images a stage-2 block. Bound at 3,072 rows (beam
3), bf16: ~107 MB of device bytes, 0.032 ms at 3.35 TB/s. In fp32, and at
other widths, "simt": one kernel of 8 rows a block with fp32 FMAs on the
CUDA cores throughout, bounded by their 67 TFLOP/s (0.05 ms at 1,024 rows).

The two heads share one product, in two instances picked by
``head_instance``: in bf16 the tensor-core instance (wgmma on a ring of
shared-memory tiles that bulk asynchronous copies fill from the tiled
weight of ``head_kernel_tiles``, which ``PreparedHead.kernel_t`` carries;
z = chat + h formed once a band of rows; the selection on the
accumulators, one partial a row and vocab split, ``head_plan``), bounded by
the card's bf16 tensor rate (10.7 GFLOP at 1,024 rows: 0.011 ms on an H100
SXM); in fp32, which the tensor cores only take as TF32, exact FMAs on the
CUDA cores with one partial a row and 128-column tile, bounded by their
fp32 rate (0.16 ms).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

NEG = -1e30
HEAD_TILE = 128  # vocab columns of one product tile of the head kernels (BN, MMA_BN)
HEAD_TILE_K = 64  # k of one tile of the tiled weight: a 128-byte swizzle row of bf16 (MMA_BK)
HEAD_MMA_MAX_H = 512  # the band's z, 128 rows x H bf16, must leave shared memory for the ring
HEAD_BAND_ROWS = 128  # rows of a block of the tensor-core heads: two warpgroups of 64
TOPK_WIDE_BAND_MAX_W = 32  # longer top-W lists need the room of half the band: 64 rows
H100_SMS = 132
CELL_K_STEP = 64  # k of a ring chunk of the mma cell's stage 1: a 128-byte row of bf16 (CELL_CK)
CELL_BAND_ROWS = 64  # rows of a stage-1 block of the mma cell (CELL_BM)
CELL_UNITS = 32  # hidden units of a stage-1 block of the mma cell (CELL_NU)
CELL_SIMT_ROWS = 8  # rows of a block of the SIMT cell (ROWS)
CELL_BLOCK_ROWS = 24  # rows of a stage-2 block at most, unless one image's beam has more
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_cuda(names, tensors, dtype, device):
    for name, t in zip(names, tensors):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_device(names, tensors, device):
    """Every operand on x's device, which picks the kernel or the twin."""
    for name, t in zip(names, tensors):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device} (where x is)")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def _check_runs_on(what: str, device):
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")


def tracing(t: torch.Tensor) -> bool:
    """Whether t is a tracer's tensor (torch.export, torch.compile), not a
    real one: a traced program records operators and cannot branch on
    data."""
    return type(t) is not torch.Tensor or torch.compiler.is_compiling()


# The operators of the kernels (module docstring). One library holds them
# all; ops/fused_block.py, ops/fused_tail.py and ops/conv_epilogue.py define
# theirs in it too.
LIBRARY = torch.library.Library("adaptive_tpu_torch", "DEF")


def define_op(schema: str, cpu, cuda, fake, on: int = 0):
    """Define ``adaptive_tpu_torch::<name>`` by its schema, with the plain
    twin as its CPU kernel, the launch as its CUDA kernel and the output
    shapes as its fake kernel. Returns call(*args): for a real tensor as
    argument ``on`` it runs the CPU or CUDA kernel itself (through the
    dispatcher's boxed call a host-bound decode step took ~60-100 us more
    host time, PERF.md §6); for a tracer's tensor (torch.export,
    torch.compile) it calls the operator, which the trace records. call.op
    is the operator."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"adaptive_tpu_torch::{name}", fake, lib=LIBRARY)
    op = getattr(torch.ops.adaptive_tpu_torch, name)

    def call(*args):
        x = args[on]
        if tracing(x):
            return op(*args)
        return (cuda if x.is_cuda else cpu)(*args)

    call.op = op
    return call


# ----------------------------------------------------------------- decode cell
def decode_cell_plain(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w=1):
    """Plain twin of the cell kernel. gx [R,4H] fp32; h, c, hp [R,H]; x
    [R,E2]; pv [R/beam_w,K,D]; V [R/beam_w,K,H]; whh [H,4H]; bhh [4H]; wx
    [E2,H]; whs [H,H]; wg, ws [H,D]; wh [D]. Row r reads image r // beam_w
    of V and pv. Returns (h', c', c_hat) in h's dtype and (alpha [R,K],
    beta [R,1]) in fp32."""
    if beam_w > 1:
        V, pv = V.repeat_interleave(beam_w, 0), pv.repeat_interleave(beam_w, 0)
    f = lambda t: t.float()  # noqa: E731
    gates = f(gx) + f(h) @ f(whh) + f(bhh)
    i, fg, g, o = torch.chunk(gates, 4, dim=-1)
    cell = torch.sigmoid(fg) * f(c) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(cell)
    s = torch.sigmoid(f(x) @ f(wx) + f(hp) @ f(whs)) * torch.tanh(cell)
    ph = h_new @ f(wg)  # [B, D]
    z = (torch.tanh(f(pv) + ph[:, None, :]) * f(wh)).sum(-1)  # [B, K]
    z_s = (torch.tanh(s @ f(ws) + ph) * f(wh)).sum(-1, keepdim=True)  # [B, 1]
    m = z.amax(-1, keepdim=True)
    e = torch.exp(z - m)
    denom = e.sum(-1, keepdim=True)
    alpha = e / denom
    m2 = torch.maximum(m, z_s)
    beta = torch.exp(z_s - m2) / (denom * torch.exp(m - m2) + torch.exp(z_s - m2))
    ctx = torch.bmm(alpha[:, None, :], f(V))[:, 0]
    chat = beta * s + (1.0 - beta) * ctx
    dt = h.dtype
    return h_new.to(dt), cell.to(dt), chat.to(dt), alpha, beta


def _check_beam_rows(R: int, V, pv, beam_w: int):
    if beam_w < 1:
        raise ValueError(f"beam_w must be >= 1, got {beam_w}")
    for name, t in (("V", V), ("pv", pv)):
        if t.shape[0] * beam_w != R:
            raise ValueError(
                f"{name} holds {t.shape[0]} images; times beam_w {beam_w} that must equal the "
                f"row count {R}: beam-major rows are batch-major beam copies "
                "(repeat_interleave layout) and V/pv come untiled")


def cell_instance(dtype, H: int, E2: int) -> str:
    """Which instance of the cell runs for CUDA tensors: "mma", the two
    stages with the tensor-core stage 1, where the operands are bfloat16
    and H and E2 are multiples of CELL_K_STEP (both products step through
    K in whole 64-wide chunks: K = H for the gates, E2 + H for the
    sentinel, whose x part ends on a chunk); "simt", fp32 FMAs on the CUDA
    cores throughout, for float32 and for any other width. A rule of shape,
    decided before launch."""
    if dtype == torch.bfloat16 and H > 0 and E2 > 0 and H % CELL_K_STEP == 0 \
            and E2 % CELL_K_STEP == 0:
        return "mma"
    return "simt"


class CellTiles(NamedTuple):
    """The cell's weights as the mma instance reads them, made once per
    checkpoint: stage 1's two products K-major (a row is one output column
    over K), stage 2's h' Wg and s Ws k-blocked (8 k of every column, then
    the next 8: a thread a column reads 16 bytes a step, its neighbours the
    next 16)."""

    whh_t: torch.Tensor  # [4H, H]: row n holds column cell_gate_order(H)[n] of w_hh
    wsen_t: torch.Tensor  # [H, E2 + H]: row u holds column u of w_x over w_hs
    watt_t: torch.Tensor  # [H / 8, 2D, 8]: [kb, j, e] = [w_g | w_s][8 kb + e, j]


def cell_gate_order(H: int, device=None) -> torch.Tensor:
    """The gate columns' order in CellTiles.whh_t: row 32a + 8g + t holds
    gate g (i, f, g, o) of unit 8a + t, i.e. column g H + 8a + t of w_hh.
    An n8 tile of the product is then one gate of 8 units, and a unit's four
    gate tiles and its sentinel tile (wsen_t row u) put its five
    pre-activations in the same lanes of mma.sync's accumulators."""
    n = torch.arange(4 * H, device=device)
    return (n // 8) % 4 * H + 8 * (n // 32) + n % 8


def cell_kernel_tiles(whh: torch.Tensor, wx: torch.Tensor, whs: torch.Tensor, wg: torch.Tensor,
                      ws: torch.Tensor) -> CellTiles:
    """w_hh [H, 4H], w_x [E2, H], w_hs [H, H], w_g and w_s [H, D] laid out
    for the mma instance (CellTiles). A copy of 2 (5H + E2 + 2D) H bytes:
    prepare_inference makes it once per checkpoint, and decode_cell makes it
    per call where it is not handed one."""
    H = whh.shape[0]
    if H % 8:
        raise ValueError(f"cell_kernel_tiles needs H a multiple of 8, got {H}")
    watt = torch.cat([wg, ws], 1)
    return CellTiles(whh.t()[cell_gate_order(H, whh.device)].contiguous(),
                     torch.cat([wx, whs], 0).t().contiguous(),
                     watt.reshape(H // 8, 8, -1).permute(0, 2, 1).contiguous())


class CellPlan(NamedTuple):
    images: int  # images of a stage-2 block, with all their beam rows (simt: 0, no stage 2)


def cell_plan(instance: str, rows: int, W: int = 1, sms: int = H100_SMS) -> CellPlan:
    """How a cell launch groups images into stage-2 blocks. Stage 1 of the
    mma instance always runs bands of CELL_BAND_ROWS rows by slices of
    CELL_UNITS hidden units (4 warps, two or three blocks an SM): 1,024 rows
    x H 512 -> 16 x 16 = 256 blocks, 3,072 -> 48 x 16 = 768. Stage 2 takes
    groups of whole images, as many as spread the images over the card's
    sms SMs in two blocks each, at most CELL_BLOCK_ROWS rows (one image
    where its beam alone has more): 1,024 images -> 4 a block at W 1 and 3,
    the fastest that tools/torch_cell_probe.py --sweep times at both shapes
    on an H100. simt has no stage 2 (blocks of CELL_SIMT_ROWS rows)."""
    if instance == "simt":
        return CellPlan(0)
    images = rows // W
    return CellPlan(max(1, min(-(-images // (2 * sms)), CELL_BLOCK_ROWS // W)))


def decode_cell_run(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w=1,
                    cell_t=None, plan=None, stages=3, out=None):
    """decode_cell's checks and launch on CUDA tensors, under a chosen plan
    (cell_plan's where None) and, for the mma instance, one stage alone
    (stages 1 or 2; 3 both), into the buffers of an earlier call (out) or
    new ones. Returns (h', c', c_hat, alpha, beta, h' fp32, s fp32): the
    last two are the mma instance's scratch (None for simt), which stage 2
    alone reads. For measurement (tools/torch_cell_probe.py, chip_smoke.py):
    it counts no launch, decode_cell does."""
    from adaptive_tpu_torch.ops.cuda import build

    _check_beam_rows(h.shape[0], V, pv, beam_w)
    R, H = h.shape
    B = R // beam_w
    E2 = x.shape[1]
    K, D = pv.shape[1], pv.shape[2]
    dt = h.dtype
    dev = gx.device
    if dev.type != "cuda":
        raise ValueError(f"decode_cell_run launches on cuda, not {dev}")
    if dt not in _DTYPE_CODE:
        raise ValueError(f"decode_cell takes float32 or bfloat16, not {dt}")
    if H % 2:
        raise ValueError(f"decode_cell needs an even hidden size, got {H}")
    for name, t, shape in (
        ("gx", gx, (R, 4 * H)), ("c", c, (R, H)), ("x", x, (R, E2)),
        ("h_prev", hp, (R, H)), ("pv", pv, (B, K, D)), ("V", V, (B, K, H)),
        ("w_hh", whh, (H, 4 * H)), ("b_hh", bhh, (4 * H,)), ("w_x", wx, (E2, H)),
        ("w_hs", whs, (H, H)), ("w_g", wg, (H, D)), ("w_s", ws, (H, D)), ("w_h", wh, (D,)),
    ):
        _check_shape(name, t, shape)
    _check_cuda(("gx",), (gx,), torch.float32, dev)
    _check_cuda(
        ("h", "c", "x", "h_prev", "pv", "V", "w_hh", "b_hh", "w_x", "w_hs", "w_g", "w_s", "w_h"),
        (h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh), dt, dev,
    )
    instance = cell_instance(dt, H, E2)
    if plan is None:
        plan = cell_plan(instance, R, beam_w, sms=_sms(dev))
    tiles = (None, None, None)
    if instance == "mma":
        if plan.images < 1:
            raise ValueError(f"the mma cell needs a stage-2 block of one image or more: {plan}")
        if stages not in (1, 2, 3):
            raise ValueError(f"stages is 1, 2 or 3, not {stages}")
        if cell_t is None:  # a copy a call: the decoders hand the prepared tiles
            cell_t = cell_kernel_tiles(whh, wx, whs, wg, ws)
        _check_shape("cell_t.whh_t", cell_t.whh_t, (4 * H, H))
        _check_shape("cell_t.wsen_t", cell_t.wsen_t, (H, E2 + H))
        _check_shape("cell_t.watt_t", cell_t.watt_t, (H // 8, 2 * D, 8))
        _check_cuda(("cell_t.whh_t", "cell_t.wsen_t", "cell_t.watt_t"), tuple(cell_t), dt, dev)
        tiles = tuple(cell_t)
    elif stages != 3:
        raise ValueError("the simt cell is one kernel: stages must be 3")
    if out is None:
        # New tensors a call, from PyTorch's caching allocator, which hands back
        # the blocks the previous step freed (host time only, no device work);
        # scratch kept across calls would be shared by calls on two streams.
        f32 = dict(dtype=torch.float32, device=dev)
        scratch = torch.empty((2, R, H), **f32).unbind(0) if instance == "mma" else (None, None)
        out = (*(torch.empty((R, H), dtype=dt, device=dev) for _ in range(3)),
               torch.empty((R, K), **f32), torch.empty((R, 1), **f32), *scratch)
    lib = build.load()
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.adaptive_cell_launch(
            _DTYPE_CODE[dt], *map(_ptr, (gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh,
                                         *out[:5], *tiles, *out[5:])),
            R, beam_w, H, E2, K, D, plan.images, stages,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "decode_cell")
    return out


def decode_cell(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w=1, cell_t=None):
    """One fused decode cell (arguments as decode_cell_plain). Launches the
    CUDA kernel for CUDA tensors (cell_instance's, cell_plan's plan; the
    mma instance reads cell_t, the CellTiles of these weights, made here
    where None); runs the plain twin for CPU tensors. Counts a launch in
    decode_cell.launches (beam_w == 1) or decode_cell.launches_beam
    (beam_w > 1, the beam-major kernel): one a call, though the mma
    instance starts two kernels."""
    _check_beam_rows(h.shape[0], V, pv, beam_w)
    _check_runs_on("decode_cell", gx.device)
    tiles = (None, None, None) if cell_t is None else tuple(cell_t)
    return tuple(_decode_cell_op(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w,
                                 *tiles))


def _decode_cell_cpu(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w, *tiles):
    return decode_cell_plain(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w)


def _decode_cell_cuda(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w, whh_t,
                      wsen_t, watt_t):
    cell_t = None if whh_t is None else CellTiles(whh_t, wsen_t, watt_t)
    out = decode_cell_run(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh, beam_w,
                          cell_t=cell_t)
    if beam_w == 1:
        decode_cell.launches += 1
    else:
        decode_cell.launches_beam += 1
    return out[:5]


def _decode_cell_fake(gx, h, c, x, hp, pv, V, *weights_and_tiles):
    R, H = h.shape
    return (*(h.new_empty((R, H)) for _ in range(3)),
            h.new_empty((R, pv.shape[1]), dtype=torch.float32),
            h.new_empty((R, 1), dtype=torch.float32))


_decode_cell_op = define_op(
    "decode_cell(Tensor gx, Tensor h, Tensor c, Tensor x, Tensor hp, Tensor pv, Tensor V, "
    "Tensor whh, Tensor bhh, Tensor wx, Tensor whs, Tensor wg, Tensor ws, Tensor wh, "
    "int beam_w, Tensor? whh_t, Tensor? wsen_t, Tensor? watt_t) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _decode_cell_cpu, _decode_cell_cuda, _decode_cell_fake)
decode_cell.launches = 0
decode_cell.launches_beam = 0


def cell_operands(lstm: Dict, atten: Dict, sentinel: Dict) -> Tuple[torch.Tensor, ...]:
    """(w_hh, b_hh, w_x, w_hs, w_g, w_s, w_h) for decode_cell from the
    JAX-layout parameter dicts."""
    return (lstm["w_hh"], lstm["b_hh"], sentinel["affine_x"]["kernel"],
            sentinel["affine_h"]["kernel"], atten["affine_g"]["kernel"],
            atten["affine_s"]["kernel"], atten["affine_h"]["kernel"].reshape(-1))


def adaptive_decode_cell_fused(lstm: Dict, atten: Dict, sentinel: Dict, x, h_in,
                               c_in, h_prev, V, pv, beam_w: int = 1, cell_t=None):
    """LSTM + sentinel + adaptive attention for one token.

    x [R,2E], h_in/c_in/h_prev [R,H], V [R/beam_w,K,H], pv [R/beam_w,K,D].
    Returns (h [R,H], c [R,H], c_hat [R,H], alpha [R,K] fp32, beta [R,1]
    fp32). beam_w > 1 is the beam-major layout: row r belongs to image
    r // beam_w. The input projection stays a full-batch matmul outside the
    kernel, computed in the compute dtype and then cast to fp32, as the JAX
    package does. cell_t: the CellTiles of these weights (prepare_inference's),
    or None."""
    gx = (x @ lstm["w_ih"] + lstm["b_ih"]).float()
    return decode_cell(gx, h_in, c_in, x, h_prev, pv, V, *cell_operands(lstm, atten, sentinel),
                       beam_w=beam_w, cell_t=cell_t)


# ------------------------------------------------------------- head argmax
def greedy_head_argmax_plain(head_kernel, head_bias, chat, h, vocab_len: int):
    """Plain twin of the head kernel: (chat + h) rounded to the weight dtype,
    fp32 product and bias, columns >= vocab_len set to -1e30, first max."""
    z = (chat + h).to(head_kernel.dtype).float()
    logits = z @ head_kernel.float() + head_bias.float()
    col = torch.arange(logits.shape[1], device=logits.device)
    logits = torch.where(col < vocab_len, logits, torch.full_like(logits, NEG))
    return torch.argmax(logits, dim=-1).to(torch.int32)


class PreparedHead(tuple):
    """The padded vocab head as the pair (kernel [H, Vp], bias [Vp]) that the
    twins and the fp32 kernels take, plus ``kernel_t``: the same weight
    transposed and tiled (head_kernel_tiles), which the tensor-core instance
    reads, or None where head_instance does not pick that instance."""

    kernel_t: Optional[torch.Tensor]

    def __new__(cls, kernel, bias, kernel_t=None):
        self = super().__new__(cls, (kernel, bias))
        self.kernel_t = kernel_t
        return self


def head_instance(dtype, H: int) -> str:
    """Which instance of the head kernels runs for CUDA tensors: "mma", the
    bf16 tensor-core product, where the weight is bfloat16, H is a multiple
    of 8 (its 16-byte copies stay aligned and whole) and at most
    HEAD_MMA_MAX_H (the band's z fits in shared memory beside the ring);
    "simt", exact FMAs on the CUDA cores, for float32 and for any other H."""
    if dtype == torch.bfloat16 and H % 8 == 0 and 0 < H <= HEAD_MMA_MAX_H:
        return "mma"
    return "simt"


def head_kernel_tiles(head_kernel: torch.Tensor) -> torch.Tensor:
    """The weight [H, Vp] as the tensor-core instance reads it:
    [Vp / 128, KB, 128, 64] with KB = ceil(H / 64), where tile [t, kb] is
    the shared-memory image of W[kb * 64 :, t * 128 :].T, 128 vocab rows of
    64 k (128 bytes, k past H zero), in the 128-byte swizzle of wgmma's
    descriptors: the 16-byte chunk c of row n lies at chunk c ^ (n % 8). One
    bulk copy of 16 KB brings a tile; made once per checkpoint."""
    H, Vp = head_kernel.shape
    kb = -(-H // HEAD_TILE_K)
    wt = torch.nn.functional.pad(head_kernel.t(), (0, kb * HEAD_TILE_K - H))
    wt = wt.reshape(Vp // HEAD_TILE, HEAD_TILE, kb, 8, 8).permute(0, 2, 1, 3, 4)  # t, kb, n, c, e
    n = torch.arange(HEAD_TILE, device=wt.device)[:, None]
    chunk = torch.arange(8, device=wt.device)[None, :] ^ (n & 7)  # what lies at [n, c]
    return wt[:, :, n, chunk].reshape(Vp // HEAD_TILE, kb, HEAD_TILE, HEAD_TILE_K).contiguous()


class HeadPlan(NamedTuple):
    band_rows: int  # rows of a block; 0 for the SIMT instance
    nsplit: int  # vocab splits = partials a row
    tiles_per_split: int  # 128-column tiles a split (the last may hold fewer)


def head_plan(instance: str, rows: int, Vp: int, W: int = 1, sms: int = H100_SMS) -> HeadPlan:
    """How a head launch cuts rows x padded vocab into blocks, which fixes
    the scratch shapes: partials are [rows, nsplit] (argmax) or
    [rows, nsplit, W] and [rows, nsplit, 2] (top-W).

    simt: one partial a row and 128-column tile. mma: bands of 128 rows (64
    where W > TOPK_WIDE_BAND_MAX_W), and as many vocab splits as fill the
    card's sms SMs in one wave, each a whole number of tiles in vocab order:
    1,024 rows x 10,240 columns -> 8 bands x 16 splits of 5 tiles; 3,072
    rows -> 24 bands x 5 splits of 16 tiles."""
    ntiles = Vp // HEAD_TILE
    if instance == "simt":
        return HeadPlan(0, ntiles, 1)
    band = HEAD_BAND_ROWS if W <= TOPK_WIDE_BAND_MAX_W else HEAD_BAND_ROWS // 2
    nbands = -(-rows // band)
    tiles_per_split = -(-ntiles // max(1, min(ntiles, sms // nbands)))
    return HeadPlan(band, -(-ntiles // tiles_per_split), tiles_per_split)


def _check_head(what, head_kernel, head_bias, chat, h, vocab_len: int, head_kernel_t):
    """Checks shared by the two head wrappers on CUDA tensors. Returns the
    instance and the tiled weight it reads (None for simt)."""
    B, H = chat.shape
    Vp = head_kernel.shape[1]
    dt = head_kernel.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"{what} takes float32 or bfloat16, not {dt}")
    if Vp % HEAD_TILE:
        raise ValueError(f"padded vocab {Vp} must be a multiple of {HEAD_TILE}")
    if not 0 < vocab_len <= Vp:
        raise ValueError(f"vocab_len {vocab_len} outside (0, {Vp}]")
    _check_shape("h", h, (B, H))
    _check_shape("head_kernel", head_kernel, (H, Vp))
    _check_shape("head_bias", head_bias, (Vp,))
    _check_cuda(("chat", "h", "head_kernel", "head_bias"),
                (chat, h, head_kernel, head_bias), dt, chat.device)
    instance = head_instance(dt, H)
    if instance == "simt":
        return instance, None
    if head_kernel_t is None:  # a 2 H Vp byte copy a call: the decoders hand theirs
        head_kernel_t = head_kernel_tiles(head_kernel)
    _check_shape("head_kernel_t", head_kernel_t,
                 (Vp // HEAD_TILE, -(-H // HEAD_TILE_K), HEAD_TILE, HEAD_TILE_K))
    _check_cuda(("head_kernel_t",), (head_kernel_t,), dt, chat.device)
    return instance, head_kernel_t


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def greedy_head_argmax(head_kernel, head_bias, chat, h, vocab_len: int, head_kernel_t=None):
    """argmax((chat + h) @ W + b) over the real vocab -> [B] int32.
    head_kernel [H, Vp] / head_bias [Vp] come padded from prepare_greedy_head
    (Vp a multiple of HEAD_TILE), head_kernel_t is its PreparedHead.kernel_t,
    the tiled weight (made here, a copy a call, where the tensor-core
    instance runs without it). Launches the CUDA kernel for CUDA tensors;
    runs the plain twin for CPU tensors."""
    _check_runs_on("greedy_head_argmax", chat.device)
    return _greedy_head_argmax_op(head_kernel, head_bias, chat, h, vocab_len, head_kernel_t)


def _greedy_head_argmax_cpu(head_kernel, head_bias, chat, h, vocab_len, head_kernel_t):
    return greedy_head_argmax_plain(head_kernel, head_bias, chat, h, vocab_len)


def _greedy_head_argmax_cuda(head_kernel, head_bias, chat, h, vocab_len, head_kernel_t):
    from adaptive_tpu_torch.ops.cuda import build

    instance, w_t = _check_head("greedy_head_argmax", head_kernel, head_bias, chat, h,
                                vocab_len, head_kernel_t)
    B, H = chat.shape
    Vp = head_kernel.shape[1]
    dt = head_kernel.dtype
    plan = head_plan(instance, B, Vp, sms=_sms(chat.device))
    part_v = torch.empty((B, plan.nsplit), dtype=torch.float32, device=chat.device)
    part_i = torch.empty((B, plan.nsplit), dtype=torch.int32, device=chat.device)
    out = torch.empty((B,), dtype=torch.int32, device=chat.device)
    lib = build.load()
    with torch.cuda.device(chat.device):  # the launch goes to the current device
        err = lib.head_argmax_launch(
            _DTYPE_CODE[dt], *map(_ptr, (chat, h, head_kernel, w_t, head_bias, part_v, part_i,
                                         out)),
            B, H, Vp, vocab_len, plan.nsplit, plan.tiles_per_split,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "greedy_head_argmax")
    greedy_head_argmax.launches += 1
    return out


_greedy_head_argmax_op = define_op(
    "greedy_head_argmax(Tensor head_kernel, Tensor head_bias, Tensor chat, Tensor h, "
    "int vocab_len, Tensor? head_kernel_t) -> Tensor",
    _greedy_head_argmax_cpu, _greedy_head_argmax_cuda,
    lambda head_kernel, head_bias, chat, *rest: chat.new_empty(chat.shape[:1],
                                                               dtype=torch.int32), on=2)
greedy_head_argmax.launches = 0


# ------------------------------------------------------------- head top-W
def topk_lower_index_first(x, k: int):
    """(values, int64 indices) of the k largest entries along the last dim,
    in descending order with equal values in ascending index order, as
    lax.top_k gives them. torch.topk does not promise the order of equal
    values, so this takes a stable descending sort."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def beam_head_topk_plain(head_kernel, head_bias, chat, h, vocab_len: int, W: int):
    """Plain twin of the top-W head kernel: (chat + h) rounded to the weight
    dtype, fp32 product and bias, columns >= vocab_len set to -1e30; then
    the row's top-W (lower index first on ties) and its logsumexp, where the
    masked columns add exp(-1e30 - max) = 0. Returns (topv [R,W] fp32,
    topi [R,W] int32, lse [R,1] fp32)."""
    z = (chat + h).to(head_kernel.dtype).float()
    logits = z @ head_kernel.float() + head_bias.float()
    col = torch.arange(logits.shape[1], device=logits.device)
    logits = torch.where(col < vocab_len, logits, torch.full_like(logits, NEG))
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    topv, topi = topk_lower_index_first(logits, W)
    return topv, topi.to(torch.int32), lse


def beam_head_topk(head_kernel, head_bias, chat, h, vocab_len: int, W: int, head_kernel_t=None):
    """Top-W of (chat + h) @ W + b over the real vocab, and the row's
    logsumexp, so topv - lse are the rows' top-W log-probs. Same operands
    as greedy_head_argmax; 1 <= W <= HEAD_TILE (a 128-column tile fills a
    row's list). Launches the CUDA kernel for CUDA tensors; runs the plain
    twin for CPU tensors."""
    if not 1 <= W <= HEAD_TILE:
        raise ValueError(f"beam_head_topk takes 1 <= W <= {HEAD_TILE}, got W={W}")
    _check_runs_on("beam_head_topk", chat.device)
    return tuple(_beam_head_topk_op(head_kernel, head_bias, chat, h, vocab_len, W,
                                    head_kernel_t))


def _beam_head_topk_cpu(head_kernel, head_bias, chat, h, vocab_len, W, head_kernel_t):
    return beam_head_topk_plain(head_kernel, head_bias, chat, h, vocab_len, W)


def _beam_head_topk_cuda(head_kernel, head_bias, chat, h, vocab_len, W, head_kernel_t):
    from adaptive_tpu_torch.ops.cuda import build

    instance, w_t = _check_head("beam_head_topk", head_kernel, head_bias, chat, h, vocab_len,
                                head_kernel_t)
    R, H = chat.shape
    Vp = head_kernel.shape[1]
    dt = head_kernel.dtype
    dev = chat.device
    plan = head_plan(instance, R, Vp, W, sms=_sms(dev))
    part_v = torch.empty((R, plan.nsplit, W), dtype=torch.float32, device=dev)
    part_i = torch.empty((R, plan.nsplit, W), dtype=torch.int32, device=dev)
    part_ms = torch.empty((R, plan.nsplit, 2), dtype=torch.float32, device=dev)
    topv = torch.empty((R, W), dtype=torch.float32, device=dev)
    topi = torch.empty((R, W), dtype=torch.int32, device=dev)
    lse = torch.empty((R, 1), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.head_topk_launch(
            _DTYPE_CODE[dt], *map(_ptr, (chat, h, head_kernel, w_t, head_bias, part_v, part_i,
                                         part_ms, topv, topi, lse)),
            R, H, Vp, vocab_len, W, plan.nsplit, plan.tiles_per_split, plan.band_rows,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "beam_head_topk")
    beam_head_topk.launches += 1
    return topv, topi, lse


def _beam_head_topk_fake(head_kernel, head_bias, chat, h, vocab_len, W, head_kernel_t):
    R = chat.shape[0]
    return (chat.new_empty((R, W), dtype=torch.float32), chat.new_empty((R, W), dtype=torch.int32),
            chat.new_empty((R, 1), dtype=torch.float32))


_beam_head_topk_op = define_op(
    "beam_head_topk(Tensor head_kernel, Tensor head_bias, Tensor chat, Tensor h, "
    "int vocab_len, int W, Tensor? head_kernel_t) -> (Tensor, Tensor, Tensor)",
    _beam_head_topk_cpu, _beam_head_topk_cuda, _beam_head_topk_fake, on=2)
beam_head_topk.launches = 0

KERNEL_WRAPPERS = (decode_cell, greedy_head_argmax, beam_head_topk)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    decode_cell.launches_beam = 0
