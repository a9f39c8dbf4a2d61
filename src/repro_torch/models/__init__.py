"""The dense decoder (`layers`, `model`)."""
