"""Training: the train and eval steps (:mod:`.step`) and the trainer
with checkpoint / restart and the TMR-voted store (:mod:`.trainer`)."""
