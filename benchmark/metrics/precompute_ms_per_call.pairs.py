"""precompute_ms_per_call.pairs: device milliseconds an `align_pairs` call
spends selecting the reference frames' interest points: the program's span
"align.precompute" (`alignment/ic.precompute_level`, once a level, from
`ic.level_data`) inside "align", timed on the device by its stream markers
(`program.py`), over the traced calls. Moves pairs_per_s."""

from benchmark import program


def read(run):
    return program.device_ms_per("align.precompute", per="align", within="align") if run.kind == "pairs" else None
