"""ZeRO-1 over four gloo processes on the CPU (``{"dp": 4, "sp": 2}``, dp
across the processes): the cases of ``tests/torch_zero1_cases.py`` (its
docstring says what each holds) against a cluster of 4 processes of
``tests/torch_zero1_prog.py``, run once for the module."""

from torch_zero1_cases import (  # noqa: F401 - collected here
    cluster_fixture,
    test_a_slice_that_cuts_a_block_raises,
    test_accumulated_zero1_steps_against_the_replicated,
    test_checkpoint_resumes_bit_equal,
    test_fit_byte_counters_equal_the_layout,
    test_fit_equals_the_one_process_run,
    test_fit_moments_are_one_nth_of_the_whole,
    test_fit_zero1_against_the_replicated_fit,
    test_gloo_all_reduce_against_the_rank_order_sum,
    test_int8_payloads_equal_the_reference_bytes,
    test_n_process_checkpoint_restores_into_one_process,
    test_one_process_checkpoint_restores_into_n_processes,
    test_step_equals_the_one_process_port_fed_the_rank_order_sum,
    test_step_tracks_the_jax_sharded_optimizer,
)

cluster = cluster_fixture(4)
