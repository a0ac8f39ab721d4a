"""The reference's waveforms for the utterances a run served, and their
gaps to the program's."""

from pb import checks, util


def reference_waveforms(torch, config, weights, questions, T, device,
                        precision="float32"):
    """The reference's waveforms of utterances padded to ``T`` frames,
    each trimmed to its length."""
    from reference.model import Model, pad
    from reference.synthesis import synthesise
    x, lengths = pad(questions, T)
    with torch.no_grad():
        out = Model(config, weights, precision)(x.to(device),
                                                lengths.to(device))
        wavs = synthesise(out, lengths, config, device).cpu().numpy()
    hop = hop_of(config)
    return [wavs[i, :len(q) * hop] for i, q in enumerate(questions)]


def hop_of(config):
    return int(config["fs"] * config["frame_shift_ms"] / 1000.0)


def compare(torch, config, weights, triples, device, precision="float32"):
    """``checks.waveform_gaps`` of (questions, program waveform, padded
    length) triples against the reference, run one padded length at a
    time."""
    groups = {}
    for q, wav, T in triples:
        groups.setdefault(int(T), []).append((q, wav))
    both, shapes = [], []
    for T, group in sorted(groups.items()):
        refs = reference_waveforms(torch, config, weights,
                                   [q for q, _ in group], T, device,
                                   precision)
        both += [(wav, ref) for (_, wav), ref in zip(group, refs)]
        shapes += [(len(q), T) for q, _ in group]
    each = []
    gaps = checks.waveform_gaps(both, hop_of(config), each)
    worst = sorted(zip(each, shapes), key=lambda e: -e[0]["frame_db_p95"])
    util.log("widest gaps (frames, padded length, numbers): " + "; ".join(
        "{} {} {}".format(n, T, {k: round(v, 4) for k, v in e.items()})
        for e, (n, T) in worst[:3]))
    return gaps
