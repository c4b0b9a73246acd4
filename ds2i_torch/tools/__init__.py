"""The port's command-line tools (`python -m ds2i_torch.tools.<tool>`):
gen_collection, create_freq_index, create_wand_data and queries, as in
the reference's quick start; the WSDM'15 chain that builds the
predictor-driven block_mixed index: profile_queries, profile_decoding
(--engine resident times the port's kernels on the card),
dec_time_regression and optimal_hybrid_index; and pass_timeline, a
measurement script run on the card."""
