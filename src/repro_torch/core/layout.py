"""Layout algebra — the planner that turns distribution changes into
all-to-all steps (the paper's yellow "intermediate" block).

A *layout* maps each logical dim to the stack of grid axes sharding it,
major→minor.  The invariant that keeps blocked distributions coherent is
that shard stacks are only pushed/popped at the **minor** end: moving the
minor-most axis of dim ``u`` onto dim ``v`` is exactly one tiled all-to-all
over that grid axis (split along ``v``, concatenate along ``u``), and
preserves global block order on both dims.
"""
from __future__ import annotations

import dataclasses

Layout = dict[str, tuple[int, ...]]      # dim -> grid axis indices


@dataclasses.dataclass(frozen=True)
class Move:
    """Move grid axis ``axis`` from minor end of ``src`` onto ``dst``."""
    axis: int
    src: str
    dst: str


def normalize(layout: Layout) -> Layout:
    return {k: tuple(v) for k, v in layout.items() if v}


def local_size(dim: str, global_size: int, layout: Layout,
               grid_shape: tuple[int, ...]) -> int:
    n = global_size
    for a in layout.get(dim, ()):
        n //= grid_shape[a]
    return n


def apply_move(layout: Layout, mv: Move) -> Layout:
    out = {k: list(v) for k, v in layout.items()}
    src = out.get(mv.src, [])
    if not src or src[-1] != mv.axis:
        raise ValueError(f"{mv} illegal: {mv.axis} is not minor-most of "
                         f"{mv.src} in {layout}")
    src.pop()
    out.setdefault(mv.dst, []).append(mv.axis)
    return normalize({k: tuple(v) for k, v in out.items()})


def plan_redistribution(cur: Layout, target: Layout, sizes: dict[str, int],
                        grid_shape: tuple[int, ...],
                        max_steps: int = 64) -> list[Move]:
    """Greedy sequence of Moves taking ``cur`` to ``target``.

    Strategy: repeatedly (1) pop axes that sit on a dim where the target
    disagrees, parking them on a dim that *wants* them next (i.e. the dim's
    current stack is a proper prefix of its target and the next wanted axis
    matches); (2) if no direct placement exists, park on the dim with the
    largest local size (usually the batch dim) and retry.  Terminates for
    every pattern used by slab/pencil/volumetric plans; guarded by
    ``max_steps``.
    """
    cur = normalize(cur)
    target = normalize(target)
    moves: list[Move] = []

    def wants_next(dim: str, axis: int, lay: Layout) -> bool:
        t = target.get(dim, ())
        c = lay.get(dim, ())
        return len(c) < len(t) and t[: len(c)] == c and t[len(c)] == axis

    def divisible(dim: str, axis: int, lay: Layout) -> bool:
        return local_size(dim, sizes[dim], lay, grid_shape) \
            % grid_shape[axis] == 0

    steps = 0
    while cur != target:
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"redistribution did not converge: {cur} -> {target}")
        progressed = False
        # 1. direct placements: a minor axis someone wants right now
        for src, stack in list(cur.items()):
            if not stack:
                continue
            axis = stack[-1]
            if target.get(src, ())[: len(stack)] == tuple(stack):
                continue                    # already a prefix of target: keep
            for dst in sizes:
                if dst != src and wants_next(dst, axis, cur) \
                        and divisible(dst, axis, cur):
                    mv = Move(axis, src, dst)
                    cur = apply_move(cur, mv)
                    moves.append(mv)
                    progressed = True
                    break
            if progressed:
                break
        if progressed:
            continue
        # 2. park a blocking minor axis on the roomiest legal dim
        cand = None
        for src, stack in list(cur.items()):
            if not stack:
                continue
            if target.get(src, ()) == tuple(stack):
                continue
            axis = stack[-1]
            parks = [d for d in sizes
                     if d != src and divisible(d, axis, cur)
                     and not wants_next(d, axis, cur)]
            parks = [d for d in parks
                     if local_size(d, sizes[d], cur, grid_shape)
                     % grid_shape[axis] == 0]
            if parks:
                best = max(parks, key=lambda d: local_size(
                    d, sizes[d], cur, grid_shape))
                cand = Move(axis, src, best)
                break
        if cand is None:
            raise RuntimeError(
                f"redistribution stuck: {cur} -> {target} (sizes {sizes})")
        cur = apply_move(cur, cand)
        moves.append(cand)
    return moves
