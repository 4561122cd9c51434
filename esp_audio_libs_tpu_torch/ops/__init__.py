"""Tensor ops of the port: quantization, biquad design, polyphase contraction."""
