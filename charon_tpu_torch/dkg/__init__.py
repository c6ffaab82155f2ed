"""The port's distributed key generation: FROST's keygen math (frost.py),
whose batched generator multiplications and share checks run on the card."""
