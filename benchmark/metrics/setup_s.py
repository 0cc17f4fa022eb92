"""Set-up: from process start to the first timed request or step (imports,
kernel loads and builds, the model made on the card, inputs, warm-up)."""

UNIT = "s"


def read(run):
    return run["setup_s"]
