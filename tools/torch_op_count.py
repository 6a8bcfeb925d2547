"""Count the ATen operations of the port's plain residual chains, of the
RDOQ route and of the P wave's plain merge search (CPU).

    python tools/torch_op_count.py

Runs `hopper_q.code_residual_planes` (one wave: a 16x16 luma and two 8x8
chroma blocks per lane), the IDR mode prepass's `code_residual_rows`
(`group=3`), the wave's RDOQ route (`rdoq=True`; on the CPU its dequant
runs the plain version too) and `quant.rdoq_rows` alone, and
`merge.merge_search_plain` at 1, 3 and 5 merge candidates
(luma MC, SATD, cost and argmin of one wave) on CPU tensors, which take
the plain PyTorch versions, under torch.profiler, and prints the number of
leaf ATen operations that would launch a device kernel (views, reshapes
and allocations left out).  It is an estimate, made without a card, of
the device events that a fused kernel takes out of the eager wave loop;
the card's own count comes from `tools/torch_profile.py`.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from kvazzup_tpu_torch.ops import hopper_q, merge, quant  # noqa: E402

NO_LAUNCH = {
    "aten::view", "aten::reshape", "aten::_reshape_alias", "aten::as_strided",
    "aten::expand", "aten::empty", "aten::empty_like", "aten::slice", "aten::select",
    "aten::unsqueeze", "aten::t", "aten::transpose", "aten::detach", "aten::resize_",
    "aten::empty_strided", "aten::lift_fresh", "aten::alias", "aten::_unsafe_view",
    "aten::squeeze", "aten::permute", "aten::split", "aten::unbind", "aten::narrow",
    "aten::expand_as", "aten::view_as", "aten::result_type", "aten::item",
    "aten::_local_scalar_dense", "aten::is_nonzero"}


def leaf_ops(fn) -> int:
    """Leaf ATen operations of fn() that would launch a kernel, after a
    first call has built the constant tables."""
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = prof.events()
    parents = {id(e.cpu_parent) for e in events if e.cpu_parent is not None}
    return sum(1 for e in events if id(e) not in parents
               and e.name.startswith("aten::") and e.name not in NO_LAUNCH)


def main() -> int:
    gen = torch.Generator().manual_seed(0)

    def pix(*shape):
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.int32)

    lanes = 8
    planes = [(pix(lanes, 256), pix(lanes, 256), pix(lanes), 4)] + [
        (pix(lanes, 64), pix(lanes, 64), pix(lanes), 3) for _ in range(2)]
    flags = torch.rand(lanes, generator=gen) > 0.5
    counts = {
        "wave, intra": leaf_ops(lambda: hopper_q.code_residual_planes(planes, True)),
        "wave, per-lane intra flags": leaf_ops(
            lambda: hopper_q.code_residual_planes(planes, flags)),
        "IDR prepass, group 3": leaf_ops(lambda: hopper_q.code_residual_rows(
            pix(lanes, 256), pix(3 * lanes, 256), pix(lanes), True, 4, group=3)),
    }
    lam2 = torch.rand(lanes, generator=gen) * 1000
    counts["wave, RDOQ route"] = leaf_ops(lambda: hopper_q.code_residual_planes(
        planes, flags, rdoq=True, lam2=lam2))
    dz = torch.full((lanes,), 171, dtype=torch.int32)
    counts["rdoq_rows alone"] = leaf_ops(lambda: quant.rdoq_rows(
        pix(lanes, 256) * 64, pix(lanes) % 52, dz, lam2, 4))
    win = torch.randint(0, 256, (lanes, 55, 55), generator=gen, dtype=torch.uint8)
    orig, lam = pix(lanes, 256), torch.rand(lanes, generator=gen) * 100
    for k_cands in (1, 3, 5):
        mvs = [torch.randint(-64, 65, (lanes, 2), generator=gen, dtype=torch.int32)
               for _ in range(k_cands)]
        counts[f"merge search, {k_cands} cand."] = leaf_ops(
            lambda m=mvs: merge.merge_search_plain(win, m, orig, lam, 16, 16))
    for k, n in counts.items():
        print(f"{k:28s} {n:4d} leaf ATen ops", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
