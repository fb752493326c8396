"""Writes ``csrc/wgmma_ops.cuh``: the ``wgmma`` instructions the bf16 flash
kernel issues, one inline-PTX wrapper per shape.

A ``wgmma.mma_async`` of shape m64nNk16 names each of its N/2 f32
accumulator registers in the instruction, so every N needs its own asm
statement; writing them out by hand invites a miscounted operand.  The
header is generated and committed (nothing runs this at build time):

    python -m repro_torch.kernels.wgmma_gen

``tests/test_torch_kernels.py`` checks that the committed header is what
this module renders.
"""

from __future__ import annotations

from pathlib import Path

HEADER = Path(__file__).resolve().parents[1] / "csrc" / "wgmma_ops.cuh"

# N of S = Q K^T is block_k; N of O += P V is the head dim
SS_SHAPES = (16, 32, 48, 64, 128, 192, 256)
RS_SHAPES = (32, 64, 128)


def _regs(first: int, count: int) -> str:
    return ", ".join(f"%{first + i}" for i in range(count))


def _outputs(count: int) -> str:
    lines, row = [], []
    for i in range(count):
        row.append(f'"+f"(d[{i}])')
        if len(row) == 4:
            lines.append(", ".join(row))
            row = []
    if row:
        lines.append(", ".join(row))
    return ",\n          ".join(lines)


def _ss(n: int) -> str:
    r = n // 2
    return f"""
// D[64 x {n}] (+)= A[64 x 16] * B[16 x {n}]; A and B K-major in shared memory
template <>
struct WgmmaSS<{n}> {{
  static __device__ __forceinline__ void mma(float (&d)[{r}], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(0, r)}}}, "
        "%{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
        : {_outputs(r)}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
}};
"""


def _rs(n: int) -> str:
    r = n // 2
    return f"""
// D[64 x {n}] += A[64 x 16] * B[16 x {n}]; A in registers (bf16 pairs),
// B MN-major in shared memory (the transpose bit set)
template <>
struct WgmmaRS<{n}> {{
  static __device__ __forceinline__ void mma(float (&d)[{r}],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(0, r)}}}, "
        "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
        : {_outputs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }}
}};
"""


def render() -> str:
    parts = [
        "// Generated by python -m repro_torch.kernels.wgmma_gen; do not "
        "edit.\n"
        "//\n"
        "// wgmma.mma_async wrappers for the bf16 flash kernel "
        "(flash_attention.cu):\n"
        "// f32 accumulators, bf16 operands, m64nNk16.  The accumulator of "
        "thread t\n"
        "// (warp w = t / 32 of the warpgroup, lane l) holds, for each "
        "8-column group\n"
        "// g, d[4g + 2i + j] = D[16w + l / 4 + 8i][8g + 2(l % 4) + j].\n"
        "#pragma once\n\n#include <cstdint>\n\n"
        "template <int N>\nstruct WgmmaSS;\n\n"
        "template <int N>\nstruct WgmmaRS;\n"]
    parts += [_ss(n) for n in SS_SHAPES]
    parts += [_rs(n) for n in RS_SHAPES]
    return "".join(parts)


def main() -> None:
    HEADER.write_text(render())
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
