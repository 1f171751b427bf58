"""The backward of a training step, ms: CUDA events at ``train_step``'s
``on_phase`` marks "forward" and "backward", the mean over the window's
steps."""


def read(rec):
    ms = rec.cuda_ms.get("backward")
    return sum(ms) / len(ms) if ms else None
