"""repro_torch.configs — workload configurations of the port.

The paper's own plane-wave workload (:mod:`.fftb_paper`) and the
language-model configurations of the reference's LM stack
(:mod:`.base`: ``ArchConfig``, ``SHAPES``, ``ARCH_IDS``, ``get_config``;
one module per architecture), each the reference's field for field.
"""
