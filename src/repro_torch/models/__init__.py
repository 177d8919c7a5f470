"""repro_torch.models — the LM stack's model families (the reference's
``models/``): dense, MoE and VLM transformers, Mamba-2 (SSD), the
RG-LRU hybrid (RecurrentGemma) and the encoder-decoder (Whisper), as
``nn.Module``s behind one bundle interface (:func:`.model_zoo.build`).
"""
