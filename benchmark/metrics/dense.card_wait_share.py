"""dense.card_wait_share: of the last finished `dense.patch_match_stereo`
job, for each pass and card, the share, in percent, of the pass's wall
time in which that card had no `dense.solve` span open, as the mean over
passes and cards, from the program's spans
(`colmap_tpu_torch/util/timer.py`).

A pass's solves are the `dense.solve` spans whose parent is its
`dense.pass` span. They are grouped by their `card` attribute, and, in a
pass where no solve has one (a program without it), by the thread that
ran them: each shard has a thread of its own in every pass. A pass's
`cards` attribute, where it has one, counts every card of the pass, so a
card with no solve reads 100%. On one card it is the host's share of the
pass. A program without these spans reads nothing."""


def read(run):
    from benchmark.harness import union_seconds
    from colmap_tpu_torch.util import timer

    last_job = getattr(timer, "last_job", None)
    spans = last_job("dense.patch_match_stereo") if last_job else []
    shares = []
    for p in (s for s in spans if s.name == "dense.pass"):
        solves = [s for s in spans
                  if s.name == "dense.solve" and s.parent == p.id]
        wall = p.end - p.start
        if not solves or wall <= 0:
            continue
        by_card = any("card" in s.attrs for s in solves)
        groups = {}
        for s in solves:
            groups.setdefault(s.attrs.get("card") if by_card else s.thread,
                              []).append((s.name, s.start, s.end))
        cards = max(int(p.attrs.get("cards", 0)), len(groups))
        # union_seconds takes microseconds; the spans' clock is in ns
        shares += [1.0 - 1e6 * union_seconds(g) / wall
                   for g in groups.values()]
        shares += [1.0] * (cards - len(groups))
    return 100.0 * sum(shares) / len(shares) if shares else None
