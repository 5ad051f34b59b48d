"""The port's ``InferenceEngine`` over the model's own ``DenseStore``: the
whole table on the card, ``BucketedBatch`` over the traffic's ladder, the
"dual" plan of every bucket compiled and run once by ``warmup()``.
``predict`` picks the smallest covering bucket and chunks a block beyond
the largest."""


def build(model, traffic: dict, device):
    from repro_torch.serving import BucketedBatch, InferenceEngine
    engine = InferenceEngine(
        model, policy=BucketedBatch(ladder=tuple(traffic["ladder"])),
        device=device)
    engine.warmup()
    return engine


def steps(rows: int, traffic: dict) -> list[int]:
    """The buckets the steps of one ``predict`` of ``rows`` rows run at:
    blocks of the largest bucket, the rest in the smallest that covers
    it (``InferenceEngine.predict``)."""
    ladder = sorted(traffic["ladder"])
    full, rest = divmod(int(rows), ladder[-1])
    out = [ladder[-1]] * full
    if rest:
        out.append(min(b for b in ladder if b >= rest))
    return out
