"""The mapper's host work before it issues an update, in ms: the median,
over the ``mapper.input_pointcloud`` spans in the window's untraced part,
of its ``mapper.filter`` (NaN filter, layer growth, padding) plus its
``mapper.upload`` (every copy of the frame to the card) child spans."""

from benchmark import program_spans as P


def read(rec):
    return P.median_per(rec, "mapper.input_pointcloud",
                        lambda kids, s: P.child_ms(kids, s, ("mapper.filter", "mapper.upload")))
