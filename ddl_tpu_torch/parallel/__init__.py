"""One-device training steps and attention dispatch (slice 1 of the
port of ``ddl_tpu/parallel``)."""
