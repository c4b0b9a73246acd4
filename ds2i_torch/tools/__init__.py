"""The port's command-line tools (`python -m ds2i_torch.tools.<tool>`):
gen_collection, create_freq_index, create_wand_data and queries, as in
the reference's quick start; and pass_timeline, a measurement script run
on the card."""
