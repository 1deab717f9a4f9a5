"""Variants of #4's TMA + wgmma forward (``csrc/flash_attention.cu``),
made by string replacement, for timing against the kernel as it is:

    ATTN_VARIANT=head_fastest python3 tools/attn_times.py --src src \\
        --variant tools/attn_variants.py
    ATTN_VARIANT=group8+stages3 python3 tools/ptxas_variants.py \\
        --variants tools/attn_variants.py

``ATTN_VARIANT`` names one change or several joined by ``+``:

- ``head_fastest``: the block order with the head as the fastest index
  of ``blockIdx.x`` and the query tile the slowest, longest first across
  the whole grid (the kernel's order before groups of (b, h) pairs);
- ``group<N>``: groups of N (b, h) pairs in place of ``kWsGroup``;
- ``band<N>``: bands of N query tiles, the band slowest, then (b, h),
  then the band's tiles, longest first (a band wider than the grid's
  tiles puts all tiles of one (b, h) together);
- ``split_trunc``: P's bf16 high part by truncation (a mask and a byte
  permute, no conversion), the remainder rounded as before;
- ``stages3``: a 3-stage K/V ring where it fits (D <= 128: 230,528 bytes
  of shared memory; MLA's 192 keeps 2);
- ``d64_stages<N>``: an N-stage K/V ring at (64, 64) (32 KB a stage),
  2 stages from 80 up;
- ``pv_with_s``: at Dv = 64, PV of the tile before and S of this tile
  issued under one wait (the kernel waits for PV before it issues S at
  every width);
- ``split16``: the split-key kernel with 8- and 16-query instances (the
  kernel takes 4 at most), for ``tools/attn_times.py --split-cutoff``;
- for timing only, with a wrong output, a part of each turn taken away:
  ``no_lo`` (PV without P's remainder: two products of a pair, not
  three), ``ex2_fma`` (each exponential an FMA and a max in place of the
  special-function unit's ex2), ``no_split`` (P's registers as raw fp32
  bits, no conversion to bf16 hi + lo).

Defines ``V = {"flash_attention_<variant>": source}``, as
``tools/ptxas_variants.py`` and ``tools/attn_times.py --variant`` take it.
"""
import os
from pathlib import Path

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "csrc" / "flash_attention.cu")

# the layout's shared memory as the kernel has it, with the ring depth
# kWsStages at every width
SMEM = """\
  static constexpr int kSmem = ws_smem(kBoxes, kVBoxes, kBK);"""

# a consumer's turn as the kernel has it, PV waited for before S is
# issued at every width, and with PV and S under one wait at Dv = 64
PV_THEN_S = """\
      issue_pv<Dv>(o, pa_hi, pa_lo, sV + sp * L::kVTileBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa_hi);
      fence_regs(pa_lo);
      if (has_pv) mbar_arrive(empty_v + 8 * sp);
      wgmma_fence();
      issue_qk<D>(s, q_rows, has_s ? sK + st * L::kKTileBytes : sQ);
      wgmma_commit();
      if (cw == 0 || has_s) named_arrive(their_turn, 2 * 128);
      wgmma_wait_all();
      fence_regs(s);
"""
PV_WITH_S = """\
      issue_pv<Dv>(o, pa_hi, pa_lo, sV + sp * L::kVTileBytes);
      if constexpr (Dv > 64) {
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa_hi);
        fence_regs(pa_lo);
        if (has_pv) mbar_arrive(empty_v + 8 * sp);
        wgmma_fence();
      }
      issue_qk<D>(s, q_rows, has_s ? sK + st * L::kKTileBytes : sQ);
      wgmma_commit();
      if (cw == 0 || has_s) named_arrive(their_turn, 2 * 128);
      wgmma_wait_all();
      fence_regs(s);
      if constexpr (Dv <= 64) {
        fence_regs(o);
        fence_regs(pa_hi);
        fence_regs(pa_lo);
        if (has_pv) mbar_arrive(empty_v + 8 * sp);
      }
"""

# the block order's decode as the kernel has it
GROUP = """\
  const int64_t group_blocks = (int64_t)kWsGroup * nq;
  const int group = (int)(blockIdx.x / group_blocks);
  const int width = min(kWsGroup, p.H * B - group * kWsGroup);
  const int in_group = (int)(blockIdx.x - group * group_blocks);
  const int bh = group * kWsGroup + in_group % width;
  const int h = bh % p.H, b = bh / p.H;
  const int q0 = (nq - 1 - in_group / width) * kWsBQ;
"""

PATCHES = {
    "head_fastest": [(GROUP, """\
  int idx = blockIdx.x;
  const int h = idx % p.H;
  idx /= p.H;
  const int b = idx % B;
  const int q0 = (nq - 1 - idx / B) * kWsBQ;
""")],
    "split_trunc": [(
        """      split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa_hi[kk][r],
                 pa_lo[kk][r]);""", """\
      const uint32_t x = __float_as_uint(s[8 * kk + 2 * r]) & 0xFFFF0000u;
      const uint32_t y = __float_as_uint(s[8 * kk + 2 * r + 1]) & 0xFFFF0000u;
      pa_hi[kk][r] = __byte_perm(x, y, 0x7632);
      pa_lo[kk][r] = pack_bf16(s[8 * kk + 2 * r] - __uint_as_float(x),
                               s[8 * kk + 2 * r + 1] - __uint_as_float(y));""")],
    "pv_with_s": [(PV_THEN_S, PV_WITH_S)],
    "split16": [
        ("constexpr int kSplitMaxQueries = 4;",
         "constexpr int kSplitMaxQueries = 16;"),
        ("""  return S == 1   ? flash_attention_split_kernel<1>
         : S == 2 ? flash_attention_split_kernel<2>
                  : flash_attention_split_kernel<4>;""",
         """  return S == 1   ? flash_attention_split_kernel<1>
         : S == 2 ? flash_attention_split_kernel<2>
         : S <= 4 ? flash_attention_split_kernel<4>
         : S <= 8 ? flash_attention_split_kernel<8>
                  : flash_attention_split_kernel<16>;""")],
    # for timing only (the output is wrong): which part of a turn holds the
    # kernel back, by taking it away
    "no_lo": [(
        """    wgmma_rs(o, pa_lo[kk], vd);
""", "")],
    "ex2_fma": [(
        """    const float pe = ex2(fmaf(s[n], p.scale_log2, -m_use[(n >> 1) & 1]));""",
        """    const float pe = fmaxf(
        fmaf(fmaf(s[n], p.scale_log2, -m_use[(n >> 1) & 1]), 0.0625f, 1.f),
        0.f);""")],
    "no_split": [(
        """      split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa_hi[kk][r],
                 pa_lo[kk][r]);""", """\
      pa_hi[kk][r] = __float_as_uint(s[8 * kk + 2 * r]);
      pa_lo[kk][r] = __float_as_uint(s[8 * kk + 2 * r + 1]);""")],
}


def _apply(text: str, name: str) -> str:
    if name == "stages3" or name.startswith("d64_stages"):
        depth = ("D > 128 ? 2 : 3" if name == "stages3" else
                 f"D >= 80 ? 2 : {int(name[10:])}")
        # the ring depth from the layout, in the kernels past its
        # definition; the barriers (8 bytes each) in whole 128 bytes
        pairs = [(SMEM, f"""\
  static constexpr int kStages = {depth};
  static constexpr int kSmem = kQTileBytes +
      kStages * (kKTileBytes + kVTileBytes) +
      (8 * (1 + 4 * kStages) + 127) / 128 * 128 + 1024;""")]
        head, tail = text.split("template <int D, int NS>\n__device__ "
                                "__forceinline__ void issue_qk", 1)
        text = (head + "template <int D, int NS>\n__device__ "
                "__forceinline__ void issue_qk"
                + tail.replace("kWsStages", "L::kStages"))
    elif name.startswith("group"):
        old = "constexpr int kWsGroup = 16;"
        pairs = [(old, f"constexpr int kWsGroup = {int(name[5:])};")]
    elif name.startswith("band"):
        n = int(name[4:])
        pairs = [(GROUP, f"""\
  const int64_t band_blocks = (int64_t){n} * p.H * B;
  const int band = (int)(blockIdx.x / band_blocks);
  const int width = min({n}, nq - band * {n});
  const int in_band = (int)(blockIdx.x - band * band_blocks);
  const int bh = in_band / width;
  const int h = bh % p.H, b = bh / p.H;
  const int q0 = (nq - 1 - band * {n} - in_band % width) * kWsBQ;
""")]
    else:
        pairs = PATCHES[name]
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"{SOURCE} no longer holds what variant {name} "
                             f"replaces:\n{old}")
        text = text.replace(old, new)
    return text


_names = os.environ.get("ATTN_VARIANT", "head_fastest").split("+")
_text = SOURCE.read_text()
for _name in _names:
    _text = _apply(_text, _name)
V = {"flash_attention_" + "_".join(_names): _text}
