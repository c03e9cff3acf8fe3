"""PyTorch port, K1's cluster route (`csrc/sinkhorn_potentials.cu`): its
launch plan, compiled from the CUDA source with g++ (the data plane's
compiler; there is no nvcc here) and replayed on the host at chip_smoke's
K1_WIDE shapes, with and without debias, on a card of 132 SMs and of 16.
The source's part between `constexpr int kPlanWarps` and `// plan end` is
host and device code: `wide_plan` picks the route, the cluster size and the
form, and the kernels take their rows through `kept_chunk`, `slot_row`
and `split_row`, which the replay below calls as the kernels do.

The device's answer to "how many clusters of this size run at once"
(cudaOccupancyMaxActiveClusters) stands in as a model of 16-SM GPCs with
one block an SM, and the non-portable sizes past 8 blocks refused on one
card model and allowed on the other.
"""
import subprocess
from pathlib import Path

import pytest

import chip_smoke

SRC = (Path(__file__).resolve().parent.parent / "kd6d_pose_adlp_tpu_torch" / "csrc"
       / "sinkhorn_potentials.cu")
SMEM_MAX = 232448          # bytes of shared memory an H100 block can opt in to
MAX_REGS = 64              # kept costs a lane
FIELDS = ("route", "cs", "ncl", "kept", "pr", "smem", "problems_once", "rows_once",
          "rows_a_warp", "regs")

REPLAY = r"""
#include <cstdio>
#include <vector>
#define __host__
#define __device__
%s

// one line of FIELDS for the plan at (N, P, T, debias) on a card of `sms`
// SMs in GPCs of 16, sizes past 8 blocks refused unless allow16
static void replay(int N, int P, int T, int debias, int sms, int allow16) {
  auto live = [&](int cs, int) {
    if (cs > 8 && !allow16) return 0;
    return (sms / 16) * (16 / cs) + (sms %% 16) / cs;
  };
  const WidePlan pl = wide_plan(N, P, T, debias, %d, live);
  int problems_once = 1, rows_once = 1, most = 0;
  if (pl.route == 3 && pl.cs > 0) {
    std::vector<int> took(N, 0);
    for (int c = 0; c < pl.ncl; ++c)
      for (int n = c; n < N; n += pl.ncl) ++took[n];
    for (int n = 0; n < N; ++n) problems_once &= took[n] == 1;
    const int npass = debias ? 4 : 2, rows = npass / 2 * (P + T);
    int first[5] = {0, P, P + T, 2 * P + T, 2 * (P + T)};
    std::vector<int> seen(rows, 0);
    const int W = pl.cs * kPlanWarps;
    for (int g = 0; g < W; ++g) {
      int mine = 0;
      if (pl.kept) {
        int pass;
        const int i0 = kept_chunk(g, P, T, npass, &pass);
        for (int r = 0; i0 >= 0 && r < kKeptRW; ++r)
          if (i0 + r < pass_rows(pass, P, T)) { ++seen[first[pass] + i0 + r]; ++mine; }
      } else {
        for (int b = 0, s = g; s < stream_slots(rows); ++b, s += W) {
          rows_once &= b < 8 * pl.pr;   // the batch's potential register
          for (int grp = 0; grp < kStreamRows; ++grp) {
            const int f = slot_row(s, grp);
            if (f >= rows) continue;
            int pass;
            const int i = split_row(f, P, T, &pass);
            rows_once &= i < pass_rows(pass, P, T) && first[pass] + i == f;
            ++seen[f];
            ++mine;
          }
        }
      }
      most = mine > most ? mine : most;
    }
    for (int f = 0; f < rows; ++f) rows_once &= seen[f] == 1;
  }
  printf("%%d %%d %%d %%d %%d %%lld %%d %%d %%d %%d\n", pl.route, pl.cs, pl.ncl, pl.kept, pl.pr,
         pl.smem, problems_once, rows_once, most, pl.kept ? kKeptRegs : 0);
}

int main() {
%s
  return 0;
}
"""


def _plan_source() -> str:
    src = SRC.read_text()
    start = src.index("constexpr int kPlanWarps")
    return src[start:src.index("// plan end")]


def _cases():
    return [(n, p, t, debias, sms, allow16)
            for n, p, t, *_ in chip_smoke.K1_WIDE if max(p, t) > 128
            for debias in (1, 0) for sms, allow16 in ((132, 0), (132, 1), (16, 0), (16, 1))]


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """{case: dict of FIELDS} from the compiled replay."""
    cases = _cases()
    calls = "".join(f"  replay({n}, {p}, {t}, {d}, {s}, {a});\n" for n, p, t, d, s, a in cases)
    tmp = tmp_path_factory.mktemp("k1_plan")
    prog = tmp / "k1_plan.cpp"
    prog.write_text(REPLAY % (_plan_source(), SMEM_MAX, calls))
    exe = tmp / "k1_plan"
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.splitlines()
    assert len(lines) == len(cases)
    return {c: dict(zip(FIELDS, map(int, line.split()))) for c, line in zip(cases, lines)}


@pytest.mark.parametrize("sms", [132, 16])
def test_plan_covers_each_problem_and_row_once(plans, sms):
    """At every K1_WIDE shape past 128 points: the cluster route wherever
    the clouds fit one block's shared memory (the global route past it),
    one cluster a problem, one warp a row, the kept costs within their
    register budget, a warp's streamed batches within its potential
    registers, the
    shared memory within an H100 block's, and clusters of at most 8 blocks,
    or up to 16 only where the device runs them."""
    for (n, p, t, debias, s, allow16), pl in plans.items():
        if s != sms:
            continue
        case = (n, p, t, debias, s, allow16)
        fits = 24 * (-(-p // 4) * 4 + -(-t // 4) * 4) <= SMEM_MAX
        assert pl["route"] == (3 if fits else 2), case
        if not fits:
            continue
        assert 1 <= pl["cs"] <= (16 if allow16 else 8), case
        assert 1 <= pl["ncl"] <= n and pl["problems_once"] == 1, case
        assert pl["rows_once"] == 1, case
        assert pl["smem"] <= SMEM_MAX, case
        if pl["kept"]:
            assert p % 4 == 0 and t % 4 == 0 and 128 <= min(p, t) and max(p, t) <= 256, case
            assert pl["regs"] <= MAX_REGS and pl["rows_a_warp"] <= 8, case
        else:
            assert pl["pr"] in (1, 8) and pl["rows_a_warp"] <= 32 * pl["pr"], case


def test_plan_keeps_costs_at_256_points_and_fills_the_card(plans):
    """The 256-point KD step's solve (N = 16) keeps its costs on clusters
    of 8, one wave over 128 SMs; at N = 128 the clusters walk 8 problems
    each; the 1,000-point solve streams on clusters of 16 where the card
    runs 8 of them, else of 8: one round either way."""
    assert {k: plans[(16, 256, 256, 1, 132, 0)][k] for k in ("cs", "ncl", "kept")} \
        == dict(cs=8, ncl=16, kept=1)
    assert {k: plans[(128, 256, 256, 1, 132, 0)][k] for k in ("cs", "ncl", "kept")} \
        == dict(cs=8, ncl=16, kept=1)
    assert plans[(8, 1000, 1000, 1, 132, 1)]["cs"] == 16
    assert plans[(8, 1000, 1000, 1, 132, 0)]["cs"] == 8
    assert plans[(8, 1000, 1000, 1, 132, 0)]["kept"] == 0
