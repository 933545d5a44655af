"""The port's Trainer on reduced mamba2-130m over a corpus, on the CPU.
Its own file, apart from `tests/test_torch_ssm_train.py`: it takes half of
that file's time, and a file runs on one worker."""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np

from repro_torch.launch.train import Trainer, TrainerConfig

ARCH = "mamba2-130m"


def test_trainer_loss_decreases_on_cpu():
    """The Trainer runs reduced mamba2-130m unchanged: a learnable corpus of
    repeated short patterns, the loss falls."""
    tc = TrainerConfig(arch=ARCH, steps=20, global_batch=4, seq_len=32, lr=1e-3,
                       log_every=20, device="cpu")
    rng = np.random.default_rng(0)
    corpus = [np.tile(rng.integers(1, 64, size=8), 5).astype(np.uint32) for _ in range(64)]
    out = Trainer(tc, corpus=corpus).run()
    assert out["steps"] == 20 and len(out["losses"]) == 20
    assert all(np.isfinite(out["losses"])) and out["final_loss"] < out["losses"][0]
