"""The port's DRSformer block kernels (image_restoration_tpu_torch.kernels.
drs_block) against the JAX package's ``drs_block_pallas``.

* ``reference_drs_block`` vs JAX ``_reference_drs_block``: the plain
  composition of TKSA + MSFN, fp32, rtol=1e-4, atol=1e-5.
* ``fused_drs_block`` on the CPU (K1's and K7's plain versions plus the TKSA
  finalize) vs JAX ``drs_block_pallas._forward`` running both Pallas
  kernels in interpret mode, bf16, rtol=atol=5e-2 (the JAX tests' own
  bound, test_drs_fused_block.py: bf16 rounds in the same places, products
  are summed in other orders).
* fp32: the plain passes round nowhere, so the fused composition must equal
  the plain block (rtol=1e-4, atol=1e-5).
* The CUDA kernel computes u once per pixel in its padded natural order,
  then walks MSFN in chunks of 16 stage-2 groups through tables
  (``msfn_chunks``, ``msfn_u_tables``, ``_pack_msfn``): each chunk stages
  a few 8-channel segments of u and reads its operands at their columns.
  The walk, replayed with torch convs on those tables, must give the plain
  MSFN (fp32, rtol=atol=1e-5).

Cases cover both LN types and both hidden parities: c 16 with expansion
2.66 (hidden 42, even) and 2.0 (32), c 24 with 2.66 (hidden 63, odd: one
stage-2 group pairs d3[62] with d5[0]). C 24 in 2 heads and in one head
(against the interpret-mode kernels) run in K1's padded layout
(``kernels/widths.py``: each head padded to 16 or 32, LN over the real
channels, the top-k at the real width). The kernels themselves run only on
the card: tests/test_torch_drs_cuda.py holds them to the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_tpu.kernels import drs_block_pallas as JK
from image_restoration_tpu_torch.kernels import block as TB
from image_restoration_tpu_torch.kernels import drs_block as TK
from image_restoration_tpu_torch.ops.layernorm import layer_norm_f32

H, W, EPS = 16, 12, 1e-5
# (c, heads, expansion, ln_type): hidden 63 odd / 32 even / 42 even
CASES = [(24, 2, 2.66, "WithBias"), (16, 1, 2.0, "BiasFree"),
         (16, 2, 2.66, "BiasFree")]


def _jax_params(rng, c, heads, expansion, ln_type):
    """JAX 24-tuple (HWIO kernels). WithBias: the bias-free convs of
    DRSformer-base; BiasFree: every conv bias present."""
    h = int(c * expansion)
    conv_bias = ln_type == "BiasFree"

    def mk(*shape, sc=0.05):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    cb = (lambda *s: mk(*s, sc=0.02)) if conv_bias else (lambda *s: None)
    lnb = (lambda: mk(c, sc=0.1)) if ln_type == "WithBias" else (lambda: None)
    return (
        mk(c, sc=0.1) + 1.0, lnb(),                       # ln1
        mk(1, 1, c, 3 * c, sc=c ** -0.5), cb(3 * c),      # qkv 1x1
        mk(3, 3, 1, 3 * c, sc=0.3), cb(3 * c),            # qkv depthwise
        mk(heads, 1, 1, sc=0.3) + 1.0,                    # temperature
        tuple(mk(1, sc=0.1) + 0.25 for _ in range(4)),    # attn1..attn4
        mk(1, 1, c, c, sc=c ** -0.5), cb(c),              # project_out
        mk(c, sc=0.1) + 1.0, lnb(),                       # ln2
        mk(1, 1, c, 2 * h, sc=c ** -0.5), cb(2 * h),      # ffn project_in
        mk(3, 3, 1, 2 * h, sc=0.3), cb(2 * h),            # dwconv3x3
        mk(5, 5, 1, 2 * h, sc=0.2), cb(2 * h),            # dwconv5x5
        mk(3, 3, 2, h, sc=0.25), cb(h),                   # dwconv3x3_1
        mk(5, 5, 2, h, sc=0.15), cb(h),                   # dwconv5x5_1
        mk(1, 1, 2 * h, c, sc=(2 * h) ** -0.5), cb(c),    # project_out
    )


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _port_params(jp):
    """The same weights in torch layout (OIHW) as DRSBlockParams."""
    conv = lambda a: _t(a.transpose(3, 2, 0, 1))  # noqa: E731
    (ln1w, ln1b, wq, bq, wd, bd, temp, mix, wo, bo, ln2w, ln2b, ki, bi, k3,
     b3, k5, b5, s3, sb3, s5, sb5, kp, bp) = jp
    return TK.DRSBlockParams(
        _t(ln1w), _t(ln1b), conv(wq), _t(bq), conv(wd), _t(bd), _t(temp),
        _t(np.concatenate(mix)), conv(wo), _t(bo), _t(ln2w), _t(ln2b),
        conv(ki), _t(bi), conv(k3), _t(b3), conv(k5), _t(b5), conv(s3),
        _t(sb3), conv(s5), _t(sb5), conv(kp), _t(bp))


def _jnp(jp):
    return tuple(tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
                 else None if a is None else jnp.asarray(a) for a in jp)


def _x(rng, c, scale=1.0):
    return (rng.standard_normal((1, H, W, c)) * scale).astype(np.float32)


@pytest.mark.parametrize("c,heads,expansion,ln_type", CASES)
def test_reference_drs_block_matches_jax(c, heads, expansion, ln_type):
    rng = np.random.default_rng(c + heads)
    jp = _jax_params(rng, c, heads, expansion, ln_type)
    x = _x(rng, c)
    cfg = (c, W, heads, ln_type, EPS)
    with jax.default_matmul_precision("highest"):
        want = JK._reference_drs_block(jnp.asarray(x), _jnp(jp), cfg)
    got = TK.reference_drs_block(torch.from_numpy(x), _port_params(jp), heads,
                                 EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("c,heads,expansion,ln_type",
                         CASES[:2] + [(24, 1, 2.66, "BiasFree")])
def test_fused_drs_block_matches_jax_interpret(c, heads, expansion, ln_type):
    rng = np.random.default_rng(10 + c + heads)
    jp = _jax_params(rng, c, heads, expansion, ln_type)
    x = jnp.asarray(_x(rng, c, 0.5), jnp.bfloat16)
    cfg = (c, W, heads, ln_type, EPS)
    xc = JK.canvas_pad(x, border=JK.BORDER)
    want = JK.canvas_unpad(JK._forward(xc, _jnp(jp), cfg, interpret=True),
                           W, c, border=JK.BORDER)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = TK.fused_drs_block(xt, _port_params(jp), heads, EPS)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("c,heads,expansion,ln_type", CASES)
def test_fused_drs_block_fp32_equals_reference(c, heads, expansion, ln_type):
    rng = np.random.default_rng(20 + c)
    p = _port_params(_jax_params(rng, c, heads, expansion, ln_type))
    x = torch.from_numpy(_x(rng, c))
    np.testing.assert_allclose(TK.fused_drs_block(x, p, heads, EPS).numpy(),
                               TK.reference_drs_block(x, p, heads, EPS).numpy(),
                               rtol=1e-4, atol=1e-5)


def _replay_kernel_walk(v, x, atw, p, eps):
    """drs_apply_msfn's walk in fp32 torch, on the packed tables: u once, in
    its stored order; per chunk the staged u segments and each operand's
    column among them, the 32 operands' stage-1 taps (k1), the 16 pairs'
    stage-2 taps (k2), and the gathered project_out rows."""
    b, h, w, c = x.shape
    pk = TK._pack_msfn(p, c, "cpu")
    ao = torch.bmm(v.reshape(b, h * w, c), atw).reshape(b, h, w, c) + x
    if p.proj_b is not None:
        ao = ao + p.proj_b
    y = layer_norm_f32(ao, p.ln2_w, p.ln2_b, eps)
    acc = ao if p.out_b is None else ao + p.out_b
    ng, no = TK.GROUPS_PER_CHUNK, 2 * TK.GROUPS_PER_CHUNK
    u_all = y @ pk["win"].float()
    if pk["bin"] is not None:
        u_all = u_all + pk["bin"]
    for j in range(pk["nch"]):
        rec = pk["ctab"][j].numpy()
        k1, k2 = rec[:2].tolist()
        staged = torch.cat([u_all[..., s:s + 8] if s >= 0
                            else torch.zeros_like(u_all[..., :8])
                            for s in rec[2:2 + TK.U_SEGMENTS].tolist()], -1)
        u = staged[..., torch.from_numpy(rec[8:].view(np.uint8).astype(np.int64))]
        ops, grp = slice(j * no, (j + 1) * no), slice(j * ng, (j + 1) * ng)
        d = F.conv2d(u.permute(0, 3, 1, 2),
                     pk["w1"][ops, :k1 * k1].reshape(no, 1, k1, k1),
                     None if pk["b1"] is None else pk["b1"][ops],
                     padding=k1 // 2, groups=no)
        s = F.conv2d(torch.relu(d),
                     pk["w2"][grp, :, :k2 * k2].reshape(ng, 2, k2, k2),
                     None if pk["b2"] is None else pk["b2"][grp],
                     padding=k2 // 2, groups=ng)
        acc = acc + torch.relu(s).permute(0, 2, 3, 1) @ pk["wout"][grp].float()
    return acc


@pytest.mark.parametrize("c,heads,expansion,ln_type", CASES)
def test_kernel_chunk_tables_reproduce_msfn(c, heads, expansion, ln_type):
    rng = np.random.default_rng(30 + c)
    p = _port_params(_jax_params(rng, c, heads, expansion, ln_type))
    # the kernel's W_in and W_out are bf16: give the plain version the same
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    p = p._replace(in_w=bf(p.in_w), out_w=bf(p.out_w))
    x = torch.from_numpy(_x(rng, c))
    v, gram, ss = TB.block_front_ref(x, p.front(), heads, EPS)
    atw = TK.tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w,
                           torch.float32)
    want = TK.drs_apply_msfn_ref(v, x, atw, p, EPS)
    got = _replay_kernel_walk(v, x, atw, p, EPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _u_reads(hidden):
    """The position in stored u that each operand slot reads through the
    kernel's chunk records (segment start + column), and whether that
    segment is staged."""
    ctab = TK.msfn_u_tables(hidden)["ctab"]
    cols = np.ascontiguousarray(ctab[:, 8:]).view(np.uint8).astype(np.int64)
    segs = ctab[:, 2:2 + TK.U_SEGMENTS]
    seg = np.take_along_axis(segs, cols // 8, axis=1)
    return (seg + cols % 8).reshape(-1), (seg >= 0).reshape(-1)


def test_msfn_chunks_pair_every_operand_once():
    """Every (u channel, bank) operand is used by exactly one stage-2 group,
    in both hidden parities, and the odd width's mixed group pairs
    d3[H-1] (padded to 5x5) with d5[0]. Through the kernel's u tables each
    operand reads its own channel's stored position, from a staged segment,
    the mixed group's included."""
    for hidden in (127, 510):
        lay = TK.msfn_chunks(hidden)
        real = lay["src"] >= 0
        ops = set(zip(lay["src"][real] // hidden, lay["kind"][real] // 2,
                      lay["src"][real] % hidden))
        assert len(ops) == real.sum() == 4 * hidden
        assert sorted(lay["group"][lay["group"] >= 0]) == list(range(2 * hidden))
        assert len(lay["meta"]) * TK.GROUPS_PER_CHUNK == len(lay["group"])
        ut = TK.msfn_u_tables(hidden)
        hp = ut["hp"]
        read, staged = _u_reads(hidden)
        want = lay["src"] // hidden * hp + lay["src"] % hidden
        assert staged.all() and (read[real] == want[real]).all()
        # each stored channel is read once as a d3 and once as a d5 operand
        kinds = set(zip(read[real], lay["kind"][real] // 2))
        assert len(kinds) == 4 * hidden
        assert ut["ctab"].shape == (len(lay["meta"]), TK.CHUNK_INTS)
        assert (ut["ctab"][:, :2] == lay["meta"]).all()
    lay = TK.msfn_chunks(127)
    g = int(np.flatnonzero(lay["group"] == 63)[0])  # path 0, group 63
    assert list(lay["src"][2 * g:2 * g + 2]) == [126, 0]
    assert list(lay["kind"][2 * g:2 * g + 2]) == [1, 2]
    read, _ = _u_reads(127)
    assert list(read[2 * g:2 * g + 2]) == [126, 0]
    g = int(np.flatnonzero(lay["group"] == 127 + 63)[0])  # path 1's
    assert list(read[2 * g:2 * g + 2]) == [128 + 126, 128]


def test_cpu_wrappers_use_plain_versions_without_counting():
    rng = np.random.default_rng(3)
    p = _port_params(_jax_params(rng, 16, 1, 2.66, "WithBias"))
    x = torch.from_numpy(_x(rng, 16)).to(torch.bfloat16)
    v, gram, ss = TB.block_front_ref(x, p.front(), 1)
    atw = TK.tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w, x.dtype)
    assert atw.shape == (1, 16, 16) and atw.dtype == torch.bfloat16
    before = TK.drs_apply_msfn.launches
    assert torch.equal(TK.drs_apply_msfn(v, x, atw, p),
                       TK.drs_apply_msfn_ref(v, x, atw, p))
    assert TK.drs_apply_msfn.launches == before


def test_wrapper_never_falls_back_off_the_cpu():
    rng = np.random.default_rng(4)
    p = _port_params(_jax_params(rng, 16, 1, 2.66, "WithBias"))
    x = torch.zeros((1, H, W, 16), dtype=torch.bfloat16, device="meta")
    atw = torch.zeros((1, 16, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TK.drs_apply_msfn(x, x, atw, p)
