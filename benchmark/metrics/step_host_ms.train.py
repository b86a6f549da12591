"""Host milliseconds inside the train step (the program's span
``train.step``): what the host takes to enqueue a step's work, the mean
over the traced stretch's steps. Set beside the device's busy time a
step, it says whether the host or the device sets the pace; the parts
are ``forward_ms.train``, ``loss_ms.train``, ``backward_ms.train`` and
``optimizer_ms.train``."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "train", "train.step", "train.step",
                                 device=False)
