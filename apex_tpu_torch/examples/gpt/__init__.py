"""GPT pretraining (``python -m apex_tpu_torch.examples.gpt.pretrain_gpt``)."""
