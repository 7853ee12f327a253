"""The plain reference of each configuration's pipeline.

One module a stage, found by the stage's name in a configuration's
``reference`` list; each has ``compress(data, device, **options) ->
bytes``. They import nothing of the program under test and take nothing
it made: they work every byte out again from the input.
"""
