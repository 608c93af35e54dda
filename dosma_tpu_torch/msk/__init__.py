"""Musculoskeletal workflows (counterpart of ``dosma_tpu/msk``)."""
