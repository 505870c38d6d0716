"""Models (counterpart of paddle_tpu/models/): the decoder-only
transformer LM that the serving engine drives."""
