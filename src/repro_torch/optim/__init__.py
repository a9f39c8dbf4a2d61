from .adamw import AdamW, AdamWState, cosine_schedule
