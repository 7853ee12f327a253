"""Input corpora: one module a corpus kind, found by the ``kind`` of a
configuration's ``corpus`` entry; each has ``generate(gen, size, params)
-> u8 tensor`` on the generator's device."""
