"""Device milliseconds of a request's scores and post-processing (the
program's span ``eval.postprocess``: softmax, decode, obj×conf fusion,
candidate pool and top-k, NMS, the per-image cap): stream time between
CUDA events at its start and end, any idle of the device inside it
included, the mean over the traced stretch's requests. The program's own twin
of ``postprocess_ms.serve``."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "serve", "eval.postprocess", "eval.step",
                                 device=True)
