"""What a traffic mix drives: one module per entry
(``entries/<entry>.py``)."""
