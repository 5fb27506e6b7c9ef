"""idle_share.per_card: for each card, 100 x (1 - union of its own device
op intervals / traced slice), in percent, as the mean over the cards, from
the profiler's trace of the slice the traffic chose (`dense_cards`: the
first job's photometric pass on every card).

`idle_share.dense` takes the union of every card's ops, so one busy card
hides an idle one; this reader keeps each op's card (the traffic's
`CardTracer`), and a card of the run with no op in the slice reads 100%.
It reads nothing where the trace holds no op with a card: on the CPU, or
with the harness's own tracer, which drops the card."""


def read(run):
    from benchmark.harness import union_seconds

    tr = run.tracer
    ops = getattr(tr, "card_ops", None) if tr is not None else None
    if not ops or not tr.done or not tr.window_s:
        return None
    cards = set(range(run.chips)) | {c for c, _, _, _ in ops}
    idle = [1.0 - union_seconds([op[1:] for op in ops if op[0] == c])
            / tr.window_s for c in cards]
    return 100.0 * sum(idle) / len(idle)
