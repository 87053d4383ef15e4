"""Command-line entry points: training (``main``), offline evaluation
(``evaluate``), serving (``infer``, ``serve``), synthetic data
(``make_synthetic``) and the simulator's data collection (``demo``,
``exp_1_flat_plane``, ``exp_2_inclined_plane``, ``exp_3_force_pert``, on the
shared helpers of ``_simrun``)."""
