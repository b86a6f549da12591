"""Device milliseconds of the CT head a request (the program's span
``model.ct_head``: the serving head's projections, kernel and glue):
stream time between CUDA events at its start and end, any idle of the
device inside it included, the mean over the traced stretch's requests."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "serve", "model.ct_head", "eval.step",
                                 device=True)
