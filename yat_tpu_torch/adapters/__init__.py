"""Adapters of the port: LoRA on ``AdapterDense`` and its PEFT export."""
