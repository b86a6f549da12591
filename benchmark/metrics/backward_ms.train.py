"""Host milliseconds of the backward a train step (the program's spans
``train.backward``, one a micro-batch), summed over the step's
micro-batches: the host's wall time inside them, the mean over the
traced stretch's steps (``forward_ms.train`` says why host time)."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "train", "train.backward", "train.step",
                                 device=False)
