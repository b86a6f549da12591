"""Host milliseconds inside the eval step a request (the program's span
``eval.step``): what the host takes to enqueue a request's work, the mean
over the traced stretch's requests. Set beside the device time a request, it
says whether the host or the device sets the pace."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "serve", "eval.step", "eval.step",
                                 device=False)
