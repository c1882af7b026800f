"""One process on one card: the entry's set-up, window and check all run
in the process that prints the result."""


def setup(cell, entry):
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    tf32 = bool(cell.config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return entry.setup(cell)


def check(cell, entry, state):
    return entry.check(cell, state)
