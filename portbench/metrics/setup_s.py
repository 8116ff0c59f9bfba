"""Set-up: from the start of the process to the start of the window
(imports, graphs, model, weights, inputs, kernel builds, warm-up)."""


def read(run):
    return run.setup_s
