"""setup_s: process start to the first timed round (host clock): imports,
the kernel library, weights and state made on the device, the checked
rounds that warm every shape up."""


def read(run):
    return run.setup_s
