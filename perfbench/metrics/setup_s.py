"""setup_s: from the start of the process to the start of the window
(host clock): imports, the device, the weights, the model, the kernels'
build or load, one warm-up cycle of every shape the mix uses."""


def read(ctx):
    return ctx.setup_s
