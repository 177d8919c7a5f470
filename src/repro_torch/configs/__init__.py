"""repro_torch.configs — workload configurations of the port.

Only the paper's own plane-wave workload (:mod:`.fftb_paper`) is here;
the reference's language-model configurations belong to its LM stack,
which is not ported.
"""
