"""The port's slice of ``paddle_tpu/framework``: the card peaks table."""
