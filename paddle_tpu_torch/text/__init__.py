"""GPT model, KV-cache decode and the continuous-batching server."""
