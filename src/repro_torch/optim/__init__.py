"""AdamW with its schedules, and int8 gradient compression (port of
``repro/optim``)."""
