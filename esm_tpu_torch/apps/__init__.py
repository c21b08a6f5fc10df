"""Design applications (port of esm_tpu/apps): LM-guided MCMC design
(``lm_design``, ``schedules``) and the protein programming language
(``ppl``)."""
