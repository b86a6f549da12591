"""Host milliseconds of the model's forward a train step (the program's
spans ``train.forward``, one a micro-batch), summed over the step's
micro-batches: the host's wall time inside them, launches and any wait
included, the mean over the traced stretch's steps. A train step's host
time is what sets its pace (a 512 step launches ~12k kernels), so the
train readers split that time; how long the kernels run on the device is
the trace's to say."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "train", "train.forward", "train.step",
                                 device=False)
